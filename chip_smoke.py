#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, and run the fused sigagg slot at 1000 validators
x 4-of-6 through TorchImpl — verified on the device by default — checked
against the native oracle, then the bulk verify, the submit front door, the
FROST DKG ceremony's device paths, the guard that lands a slot the device
failed on the native rung, and the duty pipeline's signing back half.

    python3 chip_smoke.py            # the whole check (one CUDA card)
    python3 chip_smoke.py --profile  # the whole check, then one slot traced
    python3 chip_smoke.py --ab [--diagnose] [--slot-rounds N] [--widths 4096,...]
                               [NAME=DIR[:CONST=V,...] ...]
                                     # A/B of kernel builds, in turns (below)
    python3 chip_smoke.py --sass [--out DIR] [NAME=DIR[:CONST=V,...] ...]
                                     # each build's SASS to DIR (build/.../sass)
    python3 chip_smoke.py --duty     # phase 10 alone

Phases, any failure exits non-zero:
  1. device  — CUDA present; the card's name and power limit (nvidia-smi).
  2. build   — nvcc for sm_90a from ops/csrc and the point schedules'
               header; build time, registers, spills.
  3. kernels — every kernel x E bit-equal to its plain version on seeded
               inputs: the field kernels (fe_mul<E>, fe_addsub<E>, a level
               of independent operations a launch) at FE_GATE's levels
               (one element, ragged and strided segments, eight segments,
               both sides of the products' split, add, sub and neg in one
               level) with the edges 0, 1, p-1, R mod p in every segment,
               and after the slot at every level (E, segment widths and
               operations) that the slot and the committee phase launched,
               timed beside an empty kernel (the launch floor); the point kernels at
               every width the main path launches them (4096 sweep, 2048
               MSM, 1024 combine and pk subgroup check, 512-128 the MSM's
               reduction tree, 64 and 1 cofactor clear) with the edge lanes
               P+P, P+(-P), inf+Q, P+inf, inf+inf and an all-zero lane where
               the width has room, and at 1 lane a random lane and a P+P
               lane; the rows kernels with the edges 0, 1, p-1, R mod p
               (in both components of Fq2 rows): fe_mul_rows<1> at 1, 108
               and 6912 rows, fe_add_rows at 108 and 6912 rows (one Fq12
               product's 54 Fq products on 2 and 128 lanes), also split at
               n_add 1, n/2, n-1 and at n_add 0 (the subtraction, and the
               negation 0 - a), and fe_mul_rows<2> at 3, 18, 36 and 2304
               Fq2 products, general and squaring; fe_pow on a 4096-lane
               plane and on 1 row; pt_mul_shared<1,2> and pt_mul_windowed<1,2>
               at 16 lanes and pt_mul_shared<1> at 15 (MUL_GATE) with the
               edge lanes inf, a point of order 3 (through P+P and inf in
               the table and the scan), a G1 point plus one, an all-zero
               digit column, a padded point beside a real one, k = 1, and the
               scalars u^2, h_eff, 1 and 5, bit for bit (X, Y, Z words).
               Time per launch vs the plain version and the card's bound;
               the rows kernels', fe_pow's and the scalar multiplications'
               times are taken after the slot's first run, at every width
               (split, exponent, scalar or window count) it launched them,
               and at the widths above; fe_pow and the scalar
               multiplications also against the per-step loop each replaces
               (fe_mul<1> / fe_mul_rows<1>, or pt_double / pt_add launches,
               built here), device and host time.
  4. slot    — the fixed probe (seed 99, 1000 x 4-of-6, msg 0x42*32) with
               the default device verify: warm once with every kernel
               counter at 0 (the launches of one slot: pk-plane miss, device
               hash-to-G2 of the message, device pairing), median of 3 timed
               slots, all 1000 aggregates byte-identical to native
               ct_lincomb_g2, the launches and time of each step of
               plane_agg.fused_slot (its step hook; the dispatch's launches
               by step must be DISPATCH_STEPS), a tampered partial
               gives False, bad encodings raise the reference's ValueError
               texts; the same slots with verify="native" give the same
               verdicts; the steps of a first and a steady slot (launches,
               synchronised wall) on both rungs; the launches of one first
               and one steady device verify by kernel and E (a steady one
               at most 4,800), and the PyTorch ops the host dispatches in a
               steady one; the MSM's group sums, pt_reduce_groups<2> at the
               slot's width (2,048 lanes, the signatures and the message's
               pk lanes), held bit for bit against its plain version with
               the edge lanes and timed.
  5. verify  — the committee slot (64 messages, validator v signs message
               v % 64; 65 pairs, a 64-message device hash-to-G2 batch):
               True, tampered False, each verdict the native rung's, all 64
               device H(m) byte-identical to native ct_hash_to_g2; the
               1,040-pair chunked check (its 65 pairs x 16: two 1,024-lane
               chunks) True, and False with a pair of the last chunk
               tampered; then every rows and fe_pow case (width, split or
               exponent) that this phase launched and the headline slot did
               not (hash-to-G2's scans and cofactor clear at 64 messages,
               the pairing at 65 and 1,040 pairs) held against its plain
               version and timed, in the kernels JSON as committee_by_width;
               the RFC 9380 J.10.1 vector through the device hash-to-G2.
  6. bulk verify — BASELINE config 3: 500 validators at 4-of-6 (seed 99),
               400 over an attestation root and 100 over a sync-committee
               root; one peer's inbound set (500 triples, one 512-lane
               chunk) and a burst of five peers' (2,500 triples, chunks of
               1,024 / 1,024 / 452) through TorchImpl().verify_batch, counts
               at 0 just before (pk planes decoded, H(m) hashed); on both
               rungs valid True, and False with a partial of another share,
               an infinity signature, a raw curve point or a partial plus an
               order-13 point (both checked natively to be outside the
               subgroup), a bad flag byte, an infinity pubkey, and in the
               burst a replaced partial of the last chunk, each verdict
               native ct_verify_batch's; the launches of each chunk those of
               the CPU (VERIFY_CHUNK_LAUNCHES); per size and rung the median
               of 3 steady walls beside native ct_verify_batch's. The
               per-triple verify (TorchImpl().verify_batch_each, the
               attribution after a failed flush) on 1,500, 2,000 and 5,000
               of those triples, each with four bad ones (another key's
               signature, a cleared flag byte, an order-13 component, an
               infinity), counts at 0 just before: every bad triple and 256
               seeded good ones as native ct_verify, every good one True;
               then per size its steady wall and launches beside
               verify_batch's on the same triples with the tampered one
               only. Then every case it launched that phases 4-5 did not
               (pt_reduce_groups<2> at the chunks' widths among them), held
               and timed, in the kernels JSON as bulk_verify_by_width.
  7. pipeline — four 1000 x 4-of-6 slots of the probe's keys, each over its
               own message, through threshold_aggregate_verify_submit (the
               device's slot thread): byte-identical to the serial call,
               True, launches 4 times a serial slot's; a tampered slot
               between two others False, theirs untouched; the overlapped
               call's bytes; 3 rounds of 4 serial and 4 submitted slots in
               turns, the submitted median no more than the serial median
               plus the spread.
  8. dkg     — BASELINE config 4: the FROST ceremony of 6 operators for 200
               validators at threshold 4 (seed 411, the share exchange in
               process) through the port's dkg/frost.py. The main path,
               counts at 0 just before: each node's round1_batch with device
               keygen (1,000 generator multiplications, one 1,024-lane
               launch), then each node's 1,200 share checks through
               verify_shares_batch (4,800 points in chunks of 1,024 x 4 and
               704), every check on the device path; launches exactly 6
               keygen calls' and 30 chunks' (DKG_KEYGEN_LAUNCHES,
               DKG_CHUNK_LAUNCHES, as on the CPU), E = 1 kernels only. All
               6,000 commitments and PoK points byte-identical to native
               ct_pubkey; verify_round1 of every broadcast by every node;
               finalize of every validator on every node: the six agree on
               the group and share pubkeys, each own share pubkey native
               ct_pubkey of its share. A tampered share, an order-3
               commitment and an infinity commitment (device ValueError
               texts, then verify_shares_batch's CharonError at that item);
               two evaluation points (1,024 commitment points) through
               g1_lincomb_is_infinity, True and tampered False as native per
               item; one keygen call's and one chunk's launches; medians of
               3 walls: device keygen against serial native ct_pubkey at
               1,000 scalars, device share check against native per-item at
               1,200 checks. Then every case it launched that phases 4-6 did
               not, pt_reduce_groups<1> at each (width, G) with the edge
               lanes (an empty group, cancelling points, a repeated point,
               infinity and padding lanes), held and timed, in the kernels
               JSON as dkg_by_width.
  9. guard   — the device plane's guard at the headline's full width
               (ops/guard.py; phases 1-8 run with fallback_on_device_error
               off, and after phase 8 every guard counter must be 0, the
               breaker closed and no ceremony fallback taken, so a kernel
               that fails on the card fails the run): a fault-free device
               slot gives the reference bytes (native ct_lincomb_g2's) and
               verdict; one slot with a planned device_lost fault at each
               of sigagg.pack, .execute, .readback and .finish and one with
               a timeout lands on the native rung byte-identical, each
               landing counted once; a tampered partial under a fault is
               False; a bad encoding raises the reference's ValueError with
               no landing; the breaker (threshold 3, cooldown 5 s) opens on
               three failures, the next slot launches no kernel and lands
               as breaker_open, and a probe slot after the cooldown
               launches phase 4's first slot's kernels and closes it; a
               lost device pairing check gives the native verdict, its
               pairs counted native; a submitted slot whose readback is
               held past the 2 s watchdog resolves from the native rung and
               the next one runs on a fresh slot thread on the device; node
               1's share checks of phase 8 under a frost.msm fault pass
               natively, a tampered share raises phase 8's CharonError, and
               an open breaker closes device_gate. Its JSON (the counters,
               the median walls of native-landed and device slots, the
               card) is printed before the kernels JSON.
 10. duty    — the duty pipeline's signing back half of node 1 of a 4-of-6
               cluster (seed 13) through the port's tbls facade with
               TorchImpl() installed (DutyNode: ParSigEx with the batch
               verifier through the coalescer, ParSigDB, SigAgg through the
               coalescer, AggSigDB): BASELINE config 2 (100 validators, an
               attestation a slot), config 3 (500 validators, an attestation
               and a sync-committee message a slot) and 1000 validators (an
               attestation), DUTY_ROUNDS fresh slots each, every count at 0
               just before each config: the node's own partials into
               ParSigDB, five peers' sets (signed natively before) through
               MemTransport into the coalescer at its default flush_at
               (policy.flush_at_default(), one verify chunk of 1,024): a
               slot's sets flushed on the count trigger, the rest closed on
               the quorum of 5 or the timer, the verifies one at a time on
               the card; every aggregate in AggSigDB byte-identical to the
               root key's native signature; each config launched every
               kernel of the device slot and the device verify and
               pt_mul_shared<2> at X_ABS, none of OFF_PATH; a partial of
               peer 3 signed over another root beside a second duty in the
               window: the set dropped with the reference's "invalid
               partial signature", attributed to share 3, both duties
               aggregated, each failed flush attributed by exactly one
               verify_batch_each call, the window ending within the 12 s
               slot (its wall printed); a second duty's verify window closing on its
               timer while a slot runs; no guard counter moved. It prints
               the walls of the verify, of threshold -> AggSigDB (p50, max),
               of each flush, the pk-plane decodes and the host's signing
               roots, beside the card's name and power limit. Then every
               case it launched that phases 4-8 did not, held and timed, in
               the kernels JSON as duty_by_width; each kernel row's
               duty_launches is its launches on phase 10's main path.
The last four lines are the duty JSON, the guard JSON, the kernels JSON and the
device JSON.

--ab builds each variant NAME=DIR (the plane_kernels.cu and fp.cuh in DIR,
with `constexpr int CONST = V;` lines of the source set as given, e.g. the
point kernels' group sizes kAddG2=16) into build/charon_tpu_torch/ab beside
this checkout's point schedules' header; with no variant named, this
checkout's ops/csrc. It then times the point kernels of every variant in
turns (forward, then backward; device us per launch, the mean of the two)
at each width on the main path's inputs (the edge lanes with the P+P lane
made general, and at 4,096 lanes also with it), each variant held bit for
bit against the plain versions, then the rows kernels (fe_mul_rows<1>,
fe_add_rows, at n_add 0 too, at 108 and 6,912 rows; fe_mul_rows<2> at 36 and
2,304 Fq2 products), then fe_pow (the (p-3)/4 scan on planes of 12,288,
4,096 and 1,024 lanes, p-2 on 1, 2 and 8 rows, the sqrt on 6; `kPowBlock=64`
sets another block size, `kPowLanes=1` one thread a product), then the
scalar multiplications at the main path's cases and the G1 MSM's
(MUL_AB; `kMulG2=16` sets pt_mul_shared's E = 2 group size, `kMulLanes2=2`
the lanes of its products, `kMulPoints2=16` its points a block;
`kWin2Ranks=8` pt_mul_windowed's ranks a block at E = 2, `kWin1Lanes=1,
kWin1Points=32` one lane a product at E = 1), and first the field kernels at
every level of the headline slot and at single products of 2,048-12,288
elements (FE_AB; `kFeMul1Lanes=1` one thread an Fq product, `kFeMul2Lanes=4`
the Karatsuba products each split over 4 lanes, `kFeMul1SplitMax` the width
past which a level takes one thread a product, `kFeBlock` the block). POW_AB,
MUL_AB and FE_AB cover every (layout or E, width or level) at which the
headline slot launches fe_pow, pt_mul_shared and the field kernels: the
whole check fails if they do not. --kernels points,rows,pow,mul,fe picks the
groups timed (all by default). Every variant must have this checkout's C
interface, except that a tree from before the level kernels runs the field
levels one launch an operation (charon_fe_mul / fe_add / fe_sub); to compare
with a tree whose interface differs otherwise, run that tree's own
chip_smoke.py in turns with this one. --diagnose adds three builds of this
checkout's source with part of the level loops' work taken out (the point
kernels' and pt_mul_shared's run_levels, pt_mul_windowed's win_op and
win_levels), to show where a launch's time goes: no-arith (each operation
only copies a slot), no-linear (the linear levels run no operation) and
no-products (each product is an add); their outputs are wrong by design
and not checked.
--slot-rounds N then runs N rounds of the 1000 x 4-of-6 slot with each
variant's library in turn, the order alternating by round: per variant a
steady device-verified slot (and its verify phase), a steady native-verified
slot and a first slot step by step (its sweep + combine, MSM and device
verify, H(m) hashed); each side's median and quartiles and the pairs each
variant wins.
Variants of one call are comparable; calls are not.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import ctypes
import hashlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import torch

from charon_tpu_torch import native
from charon_tpu_torch import tbls as TB
from charon_tpu_torch.core import (aggsigdb, coalesce, deadline, gater, keyshares, parsigdb, parsigex,
                                   sigagg, signeddata)
from charon_tpu_torch.core import types as CT
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.crypto.serialize import (g1_from_bytes, g1_to_bytes, g2_affine_from_bytes,
                                               g2_to_bytes)
from charon_tpu_torch.dkg import frost as TF
from charon_tpu_torch.eth2 import spec as ES
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import guard as GD
from charon_tpu_torch.ops import h2c as H2C
from charon_tpu_torch.ops import pairing as PR
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.ops import point_schedule as PS
from charon_tpu_torch.ops import rows as RW
from charon_tpu_torch.tbls import torch_impl as TI
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.utils import aio, errors, faults

N_VALIDATORS, NUM_SHARES, THRESHOLD = 1000, 6, 4
MSG = b"\x42" * 32
# one signing root per committee (MAX_COMMITTEES_PER_SLOT = 64)
COMMITTEE_MSGS = [bytes([0x50 + (c % 64)]) * 31 + bytes([c]) for c in range(64)]
# RFC 9380 J.10.1: BLS12381G2_XMD:SHA-256_SSWU_RO_, msg = ""
RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
RFC_P = ((0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
          0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D),
         (0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
          0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6))

# H100 SXM: 3.35 TB/s HBM3 (data sheet); 32-bit integer multiply-adds at
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper, data sheet).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Fq work in 32-bit multiply-adds, a 32x32->64 limb product counting 2: a
# CIOS product needs 144 a_i*b_j and 144 m_i*p_j limb products; a square
# needs only the 78 distinct a_i*a_j (the doubled cross terms are shifts).
OPS_PER_FQ_PRODUCT = 2 * (12 * 12 + 12 * 12)
OPS_PER_FQ_SQUARE = 2 * (12 * 13 // 2 + 12 * 12)
OPS_PER_FQ_ADD = 3 * 12                # add/sub with carry, borrow, select per limb
# (Fq squares, other Fq products) per point op, from fp.cuh's formulas; an
# Fq2 square is 2 Fq products and an Fq2 product 3 (Karatsuba).
FQ_WORK = {("pt_double", 1): (5, 2), ("pt_double", 2): (0, 5 * 2 + 2 * 3),
           ("pt_add", 1): (4, 12), ("pt_add", 2): (0, 4 * 2 + 12 * 3)}
# every width at which the main path launched the point kernels before their
# chains moved into pt_mul_shared / pt_mul_windowed (pt_add<2> still runs at
# 1024-128, 64 and 1)
POINT_WIDTHS = (4096, 2048, 1024, 512, 256, 128, 64, 1)
POINT_KERNELS = ("pt_double", "pt_add", "pt_mul_shared", "pt_mul_windowed")


def point_ops(name: str, E: int) -> int:
    squares, products = FQ_WORK[(name, E)]
    return squares * OPS_PER_FQ_SQUARE + products * OPS_PER_FQ_PRODUCT


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(text: str) -> list[str]:
    """One line per kernel: registers, stack frame and spill bytes."""
    rows, name, props = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            props = f"stack {m.group(1)} B, spill stores {m.group(2)} B, spill loads {m.group(3)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"((?:fe_mul|fe_addsub|fe_add|pt_double|pt_add|pt_mul_shared"
                          r"|pt_mul_windowed|pt_reduce_groups)(?:_rows)?_kernel)"
                          r"(?:ILi(\d)E((?:Li\d+E)*)E)?", name)
            pw = re.search(r"fe_pow_kernelIL\w*?LayoutE(\d)E(?:Li(\d+)E)?E", name)
            short = name
            if k:
                args = re.findall(r"Li(\d+)E", k.group(3) or "")
                what = ("P, T, R" if "windowed" in k.group(1) else
                        "T" if k.group(1) == "fe_mul_kernel" else "G")
                short = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                         + (f" ({what} = {', '.join(args)})" if args else ""))
            elif pw:
                short = (f"fe_pow_kernel<{('plane', 'rows')[int(pw.group(1))]}>"
                         + (f" (T={pw.group(2)})" if pw.group(2) else ""))
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(f"{short}: {m.group(1)} registers, {props}, static shared "
                        f"{smem.group(1) if smem else 0} B")
            name, props = None, ""
    return rows


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _rand_plane(rng: random.Random, E: int, n: int, device) -> torch.Tensor:
    P = PF.P
    vals = [rng.randrange(P) if E == 1 else (rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    edges = [0, 1, P - 1, (1 << 384) % P]
    for i, e in enumerate(edges):
        vals[i] = e if E == 1 else (e, edges[-1 - i])
    return CV.port_from_ints(vals, E, device)


def _point_inputs(rng, E, n, device):
    """Random Jacobian coordinates with edge lanes: P+P (8), P+(-P) (9),
    inf+Q (10), P+inf (11), inf+inf (12), and a lane of zeros (13)."""
    X1, Y1, Z1, X2, Y2, Z2 = (_rand_plane(rng, E, n, device) for _ in range(6))
    for a, b in ((X1, X2), (Y1, Y2), (Z1, Z2)):
        b[:, :, 8] = a[:, :, 8]
    X2[:, :, 9] = X1[:, :, 9]
    Z2[:, :, 9] = Z1[:, :, 9]
    Y2[:, :, 9:10] = F.fe_sub_plain(torch.zeros_like(Y1[:, :, 9:10]),
                                    Y1[:, :, 9:10].contiguous(), E)
    Z1[:, :, 10] = 0
    Z2[:, :, 11] = 0
    Z1[:, :, 12] = 0
    Z2[:, :, 12] = 0
    for t in (X1, Y1, Z1):
        t[:, :, 13] = 0
    return X1, Y1, Z1, X2, Y2, Z2


def _time_ms(fn, reps: int) -> float:
    """Device milliseconds per call of a launch-only fn: a sleep kernel keeps
    the card busy while the host enqueues the timed launches, so the events
    bracket back-to-back kernel execution and not the host's launch cost.
    The sleep is timed too and lengthened until it outlasts the enqueue; fn
    must not synchronise, and reps calls of it must fit in the launch queue
    (past ~1,000 pending launches the host blocks on the sleep itself)."""
    fn()
    torch.cuda.synchronize()
    cycles = 200_000_000
    while True:
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < slept.elapsed_time(start):
            return start.elapsed_time(end) / reps
        if cycles > 4_000_000_000:
            raise SystemExit(f"timing: the host's enqueue ({host_ms:.1f} ms) outlasts a "
                             f"{slept.elapsed_time(start):.1f} ms sleep")
        cycles *= 4


def _wall_ms(fn, reps: int) -> float:
    """Host milliseconds per call of fn, synchronised (the plain versions
    synchronise inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _max_abs_err(got, want) -> int:
    errs = [((g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)).abs().max().item()
            for g, w in zip(got, want)]
    return int(max(errs))


# ---------------------------------------------------------------------------
# The plane field kernels: a level of independent operations a launch
# ---------------------------------------------------------------------------

FE_KERNELS = ("fe_mul", "fe_addsub")


def slot_levels(vp: int, n: int) -> dict:
    """The field levels of a first slot's dispatch, (kernel, E, shape) ->
    launches, at vp validators a bucket (the pk plane, the aggregates) and n
    partials (G2 decompression); a shape is the segments' widths (fe_mul) or
    (operation, width) pairs (fe_addsub). A steady slot has all but the pk
    plane's."""
    m, a = "fe_mul", "fe_addsub"
    levels = collections.Counter({
        # pk plane: to_mont, x², x³ and the root's check beside its standard
        # form; the subgroup check's comparison in 3 levels (phi(P)'s x beside
        # the first); y² = x³ + 4, the sign's and [u²]P's negations
        (m, 1, (vp,)): 3, (m, 1, (vp, vp)): 2, (m, 1, (vp, vp, vp)): 1, (m, 1, (vp,) * 4): 1,
        (a, 1, (("add", vp),)): 1, (a, 1, (("neg", vp),)): 2,
        # G2 decompression
        (m, 1, (n, n)): 4, (m, 2, (n,)): 2, (a, 2, (("add", n),)): 1, (a, 1, (("add", n),)): 1,
        (a, 1, (("add", n), ("sub", n), ("neg", n))): 1, (m, 1, (n, n, n)): 1,
        (m, 1, (3 * n,)): 1, (m, 1, (n,) * 4): 1, (m, 1, (n,)): 2,
        (a, 1, (("add", n), ("sub", n))): 1, (a, 1, (("add", n), ("neg", n))): 1,
        (a, 2, (("neg", n),)): 1})
    # the affine standard form
    levels.update({(m, 1, (vp, vp)): 2, (a, 1, (("add", vp), ("neg", vp))): 1, (m, 2, (vp,)): 2,
                   (m, 2, (vp, vp)): 1, (m, 1, (vp,) * 4): 1})
    return dict(levels)


def fe_cases(cases: dict) -> dict:
    """The field levels of a run, from path_counts()["cases"]: (kernel, E,
    shape) -> launches."""
    return {(name, E, shape): c for name in FE_KERNELS
            for (E, _total, shape), c in cases.get(name, {}).items()}


# the gate before the slot, edges in every segment: one element, ragged
# widths in a block, segments of several widths (lane slices of one wider
# plane), a level past the split's width (one thread a product), a level of
# the most segments, and add, sub and neg side by side
FE_GATE = (("fe_mul", 1, (1,)), ("fe_mul", 1, (33, 7, 300)), ("fe_mul", 1, (12288,)),
           ("fe_mul", 1, (5,) * 8), ("fe_mul", 2, (1,)), ("fe_mul", 2, (5, 300)),
           ("fe_mul", 2, (9000,)),
           ("fe_addsub", 1, (("add", 3), ("sub", 300), ("neg", 33), ("add", 1))),
           ("fe_addsub", 2, (("add", 17), ("neg", 5), ("sub", 64), ("neg", 1))))


def _seg_width(seg) -> int:
    return seg if isinstance(seg, int) else seg[1]


def fe_level(kernel: str, E: int, shape, device, seed: str) -> list:
    """Seeded operands of one level, as mul_level / addsub_level take them:
    each segment's a and b lane slices of one plane as wide as the level
    (one segment: the whole plane), each segment's first lanes the edges 0,
    1, p-1, R mod p in a and reversed in b."""
    rng = random.Random(seed)
    widths = [_seg_width(seg) for seg in shape]
    A, B = (torch.cat([_rand_plane(rng, E, max(n, 4), device)[..., :n] for n in widths], -1)
            for _ in range(2))
    ops, off = [], 0
    for seg, n in zip(shape, widths):
        a, b = A[..., off:off + n], B[..., off:off + n]
        k = min(n, 4)
        b[..., :k] = a[..., :k].flip(-1)
        off += n
        ops.append((a, b) if kernel == "fe_mul" else (seg[0], None if seg[0] == "neg" else a, b))
    return ops


def fe_plain(kernel: str, E: int, ops) -> list:
    """The level's plain versions, segment by segment."""
    return [CP.level_plain(*(op if kernel == "fe_addsub" else (None, *op)), E) for op in ops]


def fe_run(kernel: str, E: int, ops):
    """The wrapper: one launch of the level."""
    return (CP.mul_level if kernel == "fe_mul" else CP.addsub_level)(ops, E)


def fe_label(kernel: str, E: int, shape) -> str:
    segs = ", ".join(str(s) if isinstance(s, int) else f"{s[0]} {s[1]}" for s in shape)
    return f"{kernel}<{E}> [{segs}]"


def fe_bound(kernel: str, E: int, shape) -> tuple:
    """The level's bound: its operands and outputs once (a negation reads
    no a), against 576 multiply-adds an Fq product (3 an Fq2 product) or 36
    integer operations an Fq add."""
    if kernel == "fe_mul":
        n = sum(shape)
        return _bound(3 * E * 48 * n, n * OPS_PER_FQ_PRODUCT * (1 if E == 1 else 3))
    words = sum((2 if op == "neg" else 3) * n for op, n in shape)
    return _bound(words * E * 48, sum(n for _op, n in shape) * E * OPS_PER_FQ_ADD)


def launch_floor_ms(reps: int = 50) -> float:
    """Device ms of an empty kernel, timed as the kernels are (behind the
    sleep, back to back)."""
    lib = CP._library()
    return _time_ms(lambda: lib.charon_empty(torch.cuda.current_stream().cuda_stream), reps)


def check_fe(device, cases: dict, reps: int = 0, floor_ms: float | None = None) -> dict:
    """fe_mul and fe_addsub bit for bit against their plain versions at each
    level case (kernel, E, shape) -> the main path's launches, on fe_level's
    inputs. With reps each case is also timed; returns per (fe_mul, E) and
    per (fe_addsub, E, operation) the JSON row of its most launched case
    (an add/sub level counts for each operation it holds; a negation is a
    subtraction), with every case in by_width."""
    timed = []
    for (kernel, E, shape), launches in sorted(cases.items(), key=lambda kv: (-kv[1], str(kv[0]))):
        label = fe_label(kernel, E, shape)
        ops = fe_level(kernel, E, shape, device, label)
        err = _hold(label, fe_run(kernel, E, ops), fe_plain(kernel, E, ops))
        if not reps:
            continue
        bound_ms, by = fe_bound(kernel, E, shape)
        row = {"kernel": kernel, "E": E, "width": sum(_seg_width(s) for s in shape),
               "level": [s if isinstance(s, int) else list(s) for s in shape],
               "launches": launches, "ms": _time_ms(lambda: fe_run(kernel, E, ops), reps),
               "plain_ms": _wall_ms(lambda: fe_plain(kernel, E, ops), 2),
               "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
        timed.append(row)
        log(f"kernel {label}: bit-equal to plain (max_abs_err 0); {launches} launches on the main "
            f"path; {row['ms'] * 1e3:.2f} us/launch, plain {row['plain_ms'] * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.3f} us ({by})")
    if not reps:
        log("field levels bit-equal to plain: " + "; ".join(fe_label(*c) for c in cases))
        return {}
    rows, site_of = {}, {"add": "add", "sub": "sub", "neg": "sub"}
    for key in [("fe_mul", 1), ("fe_mul", 2)] + [("fe_addsub", E, op) for E in (1, 2)
                                                 for op in ("add", "sub")]:
        kernel, E = key[:2]
        mine = [r for r in timed if (r["kernel"], r["E"]) == (kernel, E)
                and (kernel == "fe_mul" or key[2] in {site_of[s[0]] for s in r["level"]})]
        if not mine:
            continue
        top = mine[0]
        rows[key] = {
            "name": f"{kernel}<{E}>" + (f" ({key[2]})" if kernel == "fe_addsub" else ""),
            "route": "cuda", "source": CP.KERNELS[kernel].source,
            "replaces": CP.KERNELS[kernel].site(key[-1]),
            "launches": sum(r["launches"] for r in mine), "library_ms": None,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "width", "level")},
            "floor_ms": floor_ms,
            "by_width": [{k: v for k, v in r.items() if k not in ("kernel", "E", "bound_by",
                                                                  "max_abs_err")}
                         for r in mine]}
    torch.cuda.synchronize()
    return rows


def _point_cases(rng, E: int, n: int, device) -> list:
    """[(label, inputs, lanes the add doubles)] at width n: the edge lanes
    8-13 of _point_inputs where n has room, else (n < 16) a window of
    random lanes and, as a second case, the window that starts at the P+P
    lane."""
    pts = _point_inputs(rng, E, max(n, 16), device)
    if n >= 16:
        return [("", pts, 1)]

    def window(lo):
        return tuple(t[:, :, lo:lo + n].contiguous() for t in pts)

    return [("", window(16 - n), 0), (" P+P", window(8), 1)]


def _without_pp(pts):
    """The same add inputs with lane 8 a general lane (q from lane 14): no
    lane needs the P+P double, as on the main path."""
    out = [t.clone() for t in pts]
    for t in out[3:]:
        t[:, :, 8] = t[:, :, 14]
    return tuple(out)


def check_point_kernels(device, widths, reps: int) -> dict:
    """pt_double<E> and pt_add<E> against their plain versions at every
    width of the main path; returns per-(kernel, E, width) rows, timed on
    the first case of each width."""
    rng = random.Random(5678)
    rows = {}
    for E in (1, 2):
        for n in widths:
            for i, (label, pts, n_dbl) in enumerate(_point_cases(rng, E, n, device)):
                cases = {
                    "pt_double": (lambda: CP.pt_double(*pts[:3], E),
                                  lambda: C.pt_double_plain(*pts[:3], E),
                                  6 * E * 48 * n, n * point_ops("pt_double", E)),
                    "pt_add": (lambda: CP.pt_add(*pts, E), lambda: C.pt_add_plain(*pts, E),
                               9 * E * 48 * n,
                               n * point_ops("pt_add", E) + n_dbl * point_ops("pt_double", E)),
                }
                for name, (kern, plain, nbytes, ops) in cases.items():
                    got = kern()
                    torch.cuda.synchronize()
                    err = _max_abs_err(got, plain())
                    if err != 0:
                        raise SystemExit(f"kernel {name}<{E}> disagrees with its plain version "
                                         f"at {n} lanes{label}: max abs limb difference {err}")
                    if i:
                        log(f"kernel {name}<{E}> n={n}{label}: bit-equal to plain")
                        continue
                    ms = _time_ms(kern, reps)
                    plain_ms = _wall_ms(plain, 2)
                    bound_ms, by = _bound(nbytes, ops)
                    row = rows[(name, E, n)] = {
                        "name": f"{name}<{E}>", "route": "cuda",
                        "source": CP.KERNELS[name].source, "replaces": CP.KERNELS[name].replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": by, "library_ms": None, "width": n,
                    }
                    extra = ""
                    if name == "pt_add" and n_dbl:
                        general = _without_pp(pts)
                        if _max_abs_err(CP.pt_add(*general, E), C.pt_add_plain(*general, E)):
                            raise SystemExit(f"kernel pt_add<{E}> disagrees with its plain "
                                             f"version at {n} lanes without the P+P lane")
                        row["ms_no_pp"] = _time_ms(lambda: CP.pt_add(*general, E), reps)
                        extra = f" ({row['ms_no_pp'] * 1e3:.2f} us with no P+P lane)"
                    log(f"kernel {name}<{E}> n={n}: bit-equal to plain (max_abs_err 0); "
                        f"{ms * 1e3:.2f} us/launch{extra}, plain {plain_ms * 1e3:.1f} us, bound "
                        f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    torch.cuda.synchronize()
    return rows


# the rows kernels' gate before the slot: 108 and 6,912 rows (one Fq12
# product's 54 Fq products on 2 and 128 lanes), one row, the splits n_add 0
# (the subtraction), 1, n/2, n-1 (n_add = n is the plain add), and Fq2
# products at 3, 18, 36 and 2,304 (the committee slot's widest)
ROWS_WIDTHS = (108, 6912)
FQ2_WIDTHS = (3, 18, 36, 2304)
FQ2_TIMED = (36, 2304)
ROWS_GATE = {
    ("fe_mul_rows", 1): (1, *ROWS_WIDTHS),
    ("fe_add_rows", 1): (*ROWS_WIDTHS, *((n, k) for n in ROWS_WIDTHS for k in (0, 1, n // 2, n - 1))),
    ("fe_mul_rows", 2): FQ2_WIDTHS,
}


def _rand_rows(rng: random.Random, n: int, device, E: int = 1) -> torch.Tensor:
    """(n, 12) or (n, 2, 12) seeded Montgomery rows; the edges 0, 1, p-1,
    R mod p in the first rows (for E = 2 in both components, reversed in
    the second; below 4 rows the first n of them)."""
    plane = _rand_plane(rng, E, max(n, 4), device)[..., :n]  # (E, 12, n)
    return plane.permute(2, 0, 1).contiguous() if E == 2 else plane[0].t().contiguous()


def _hold(label: str, got, want) -> int:
    err = _max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"kernel {label} disagrees with its plain version: "
                         f"max abs limb difference {err}")
    return err


def _rows_case(name: str, E: int, key, device):
    """One rows case on seeded rows, edges first: (label, width, kernel fn,
    plain fn, bytes, operations); key is a width (Fq2 rows for E = 2) or,
    for fe_add_rows, (width, n_add). The squaring of fe_mul_rows<2> and,
    at n_add = 0, the negation 0 - a are held here too."""
    n, n_add = key if isinstance(key, tuple) else (key, None)
    rng = random.Random(f"{name}<{E}> {n} {n_add}")
    a, b = _rand_rows(rng, n, device, E), _rand_rows(rng, n, device, E)
    b[:4] = a[:4].flip(0)
    label = f"{name}<{E}>" if name == "fe_mul_rows" else name
    label += f" n={n}" + (f" n_add={n_add}" if n_add is not None else "")
    if name == "fe_mul_rows" and E == 2:
        _hold(f"{label} (square)", (RW.fq2_mul_rows(a, a),), (F.rows_mul2_plain(a, a),))
        return (label, n, lambda: (RW.fq2_mul_rows(a, b),), lambda: (F.rows_mul2_plain(a, b),),
                6 * 48 * n, n * (3 * OPS_PER_FQ_PRODUCT + 5 * OPS_PER_FQ_ADD))
    if name == "fe_mul_rows":
        return (label, n, lambda: (RW.mont_mul_rows(a, b),), lambda: (F.rows_mul_plain(a, b),),
                3 * 48 * n, n * OPS_PER_FQ_PRODUCT)
    if n_add == 0:
        neg = RW.fq_neg(a)
        _hold(f"{label} (negation)", (neg,), (F.rows_sub_plain(torch.zeros_like(a), a),))
        if bool((neg[0] != 0).any()):
            raise SystemExit("fe_add_rows negation of 0 is not 0")
        return (label, n, lambda: (RW.sub_rows(a, b),), lambda: (F.rows_sub_plain(a, b),),
                3 * 48 * n, n * OPS_PER_FQ_ADD)
    if n_add is None:
        return (label, n, lambda: (RW.add_rows(a, b),), lambda: (F.rows_add_plain(a, b),),
                3 * 48 * n, n * OPS_PER_FQ_ADD)
    return (label, n, lambda: (RW.addsub_rows(a, b, n_add),),
            lambda: (F.rows_addsub_plain(a, b, n_add),), 3 * 48 * n, n * OPS_PER_FQ_ADD)


def check_rows_kernels(device, cases: dict, reps: int = 0) -> dict:
    """Each rows kernel against its plain version: cases maps (name, E) to
    {key: launches}, key as in _rows_case. With reps, each case is also
    timed (device us per launch; the plain version's synchronised wall),
    and the result holds per (name, E) the JSON row of its most launched
    key, with every key in by_width."""
    rows = {}
    for (name, E), keys in cases.items():
        timed = []
        for key, launches in sorted(keys.items(), key=lambda kv: -kv[1]):
            label, n, kern, plain, nbytes, ops = _rows_case(name, E, key, device)
            err = _hold(label, kern(), plain())
            if not reps:
                continue
            bound_ms, by = _bound(nbytes, ops)
            row = {"width": n, "launches": launches, "ms": _time_ms(kern, reps),
                   "plain_ms": _wall_ms(plain, 2), "bound_ms": bound_ms, "bound_by": by,
                   "max_abs_err": err}
            if isinstance(key, tuple):
                row["n_add"] = key[1]
            timed.append(row)
            log(f"kernel {label}: bit-equal to plain (max_abs_err 0); {launches} launches on "
                f"the main path; {row['ms'] * 1e3:.2f} us/launch, plain "
                f"{row['plain_ms'] * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us ({by})")
        if not reps:
            log(f"kernel {name}<{E}>: bit-equal to plain at " + ", ".join(map(str, keys)))
            continue
        top = timed[0]
        rows[(name, E)] = {
            "name": f"{name}<{E}>" if name == "fe_mul_rows" else name, "route": "cuda",
            "source": CP.KERNELS[name].source, "replaces": CP.KERNELS[name].replaces,
            "launches": 0, "library_ms": None,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "width") + (("n_add",) if "n_add" in top else ())},
            "by_width": [{k: v for k, v in r.items() if k not in ("bound_by", "max_abs_err")}
                         for r in timed]}
    torch.cuda.synchronize()
    return rows


def path_counts() -> dict:
    """What the counters hold since their last reset: every kernel's
    launches by (variant, width) and its calls by case (Kernel.cases)."""
    return {"widths": {name: dict(k.widths) for name, k in CP.KERNELS.items()},
            "cases": {name: dict(k.cases) for name, k in CP.KERNELS.items()}}


def other_cases(run: dict, slot: dict) -> tuple[dict, dict]:
    """The cases that `run` launched and the headline slot's run did not,
    each at the run's launches: (the rows kernels' as path_rows_cases gives
    them, every kernel's cases by name as path_counts gives them)."""
    seen = path_rows_cases(slot)
    rows = {key: {k: c for k, c in keys.items() if c and k not in seen[key]}
            for key, keys in path_rows_cases(run).items()}
    return ({key: keys for key, keys in rows.items() if keys},
            {name: {k: c for k, c in keys.items() if k not in slot["cases"].get(name, {})}
             for name, keys in run["cases"].items()})


def path_rows_cases(slot: dict) -> dict:
    """The rows cases of the main path's run (its launches by width; an
    fe_add_rows launch that subtracts, split or at n_add = 0, by (width,
    n_add)), and the gate's widths without splits at 0 launches, so that
    they are timed as well."""
    cases = {}
    for (name, E), gate in ROWS_GATE.items():
        keys = {w: 0 for w in gate if not isinstance(w, tuple)}
        for (e, n), c in slot["widths"][name].items():
            if e == E:
                keys[n] = keys.get(n, 0) + c
        if name == "fe_add_rows":
            for (_E, n, n_add), c in slot["cases"]["fe_add_rows"].items():
                keys[n] -= c
                keys[(n, n_add)] = c
        cases[(name, E)] = {k: c for k, c in keys.items() if c or k in gate}
    return cases


# ---------------------------------------------------------------------------
# fe_pow: one launch per power scan
# ---------------------------------------------------------------------------

# the exponents of the main path's scans: Fq sqrt (G1 decompression, the G2
# root's norm, hash-to-G2), the G2 root's (p-3)/4, inversion, Euler's test
POW_EXPS = {"sqrt": (PF.P + 1) // 4, "e34": (PF.P - 3) // 4, "inv": PF.P - 2,
            "euler": (PF.P - 1) // 2}
# the gate before the slot: (layout, width, exponent)
POW_GATE = (("plane", 4096, "e34"), ("rows", 1, "inv"))


def pow_case(layout: str, n: int, name: str) -> tuple:
    return (layout, n, tuple(CP.pow_digits(CP.exp_digits(POW_EXPS[name]))))


def _exponent(digits) -> int:
    e = 0
    for d in digits:
        e = (e << CP.POW_WINDOW) | d
    return e


def _pow_ops(digits) -> int:
    """32-bit multiply-adds of one scan per element, as fe_pow runs it: the
    table (14 products), then 4 squarings per further window and a product
    per nonzero one."""
    squares = CP.POW_WINDOW * (len(digits) - 1)
    products = 14 + sum(1 for d in digits[1:] if d)
    return squares * OPS_PER_FQ_SQUARE + products * OPS_PER_FQ_PRODUCT


def _pow_input(layout: str, n: int, device, seed: str) -> torch.Tensor:
    """n seeded Fq elements, the edges 0, 1, p-1, R mod p first: a
    (1, 12, n) plane or (n, 12) rows."""
    plane = _rand_plane(random.Random(seed), 1, max(n, 4), device)[..., :n].contiguous()
    return plane if layout == "plane" else plane[0].t().contiguous()


def mont_one_plane(a: torch.Tensor) -> torch.Tensor:
    """Montgomery 1 in every lane of a's (1, 12, n) shape."""
    one = torch.tensor(F.fq_from_int(1), dtype=torch.int32, device=a.device)
    return one.view(1, F.LIMBS, 1).expand(*a.shape).contiguous()


def pow_loop(lib, layout: str, a: torch.Tensor, e: int, one) -> torch.Tensor:
    """The per-step loop that fe_pow replaces, launched from `lib` outside
    the counters. Planes: cuda_plane.pow_scan as it was, a 16-entry table
    from one (14 fe_mul<1> products), then for each of the exponent's 96
    windows 4 squarings and one table product (494 launches). Rows:
    rows.pow_rows as it was, the table, then from the first nonzero window
    4 squarings and, where the window is not 0, one product, on
    fe_mul_rows<1>. `one` is mont_one_plane(a) for planes (made outside a
    timed region: its host-to-device copy would wait for the card), None
    for rows."""
    if layout == "plane":
        def mul(x, y):
            _dev, segs, outs, _key = CP.level_args("fe_mul", [(None, x, y)], 1, None)
            CP.call_level(lib, "fe_mul", 1, segs)
            return outs[0]

        tab = [one, a]
        for _ in range(2, 16):
            tab.append(mul(tab[-1], a))
        acc = one
        for d in CP.exp_digits(e):
            for _ in range(CP.POW_WINDOW):
                acc = mul(acc, acc)
            acc = mul(acc, tab[d])
        return acc

    def mul(x, y):
        out = torch.empty_like(x)
        if lib.charon_fe_mul_rows(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], 1,
                                  torch.cuda.current_stream().cuda_stream):
            raise SystemExit("fe_mul_rows<1> did not launch")
        return out

    digits = CP.pow_digits(CP.exp_digits(e))
    tab = [None, a]
    for _ in range(2, 16):
        tab.append(mul(tab[-1], a))
    acc = tab[digits[0]]
    for d in digits[1:]:
        for _ in range(CP.POW_WINDOW):
            acc = mul(acc, acc)
        if d:
            acc = mul(acc, tab[d])
    return acc


def check_pow(device, cases: dict, reps: int = 0) -> dict:
    """fe_pow in both layouts against its plain version (field.pow_plain
    over the layout's plain product) on seeded elements, edges first, and
    the edges against host pow(): cases maps (layout, width, digits) to the
    main path's launches. With reps each case is also timed, beside the
    per-step loop it replaces (device us back to back, and the loop's
    synchronised host wall); returns per layout the JSON row of its most
    launched case, with every case in by_width."""
    names = {_exponent(pow_case("plane", 1, k)[2]): k for k in POW_EXPS}
    rows = {}
    for layout in ("plane", "rows"):
        timed = []
        for (lay, n, digits), launches in sorted(cases.items(), key=lambda kv: -kv[1]):
            if lay != layout:
                continue
            e = _exponent(digits)
            label = f"fe_pow<{layout}> n={n} e={names.get(e, hex(e))}"
            a = _pow_input(layout, n, device, label)
            if layout == "plane":
                def kern(a=a, digits=digits):
                    return (CP.pow_scan(a, digits),)

                def plain(a=a, digits=digits):
                    return (F.pow_plain(a, list(digits), lambda x, y: F.fe_mul_plain(x, y, 1)),)
            else:
                def kern(a=a, e=e):
                    return (RW.pow_rows(a, e),)

                def plain(a=a, digits=digits):
                    return (F.pow_plain(a, list(digits), F.rows_mul_plain),)
            got = kern()
            err = _hold(label, got, plain())
            flat = got[0].reshape(-1, F.LIMBS) if layout == "rows" else got[0][0].t()
            vals = [0, 1, PF.P - 1, (1 << 384) % PF.P][:n]
            if F.fq_ints(flat[:len(vals)].cpu().numpy()) != [pow(v, e, PF.P) for v in vals]:
                raise SystemExit(f"kernel {label} misses host pow() on the edges")
            if not reps:
                log(f"kernel {label}: bit-equal to plain, edges equal to host pow()")
                continue
            lib = CP._library()

            one = mont_one_plane(a) if layout == "plane" else None

            def loop(a=a, e=e, lib=lib, one=one):
                return (pow_loop(lib, layout, a, e, one),)

            _hold(f"{label} (the per-step loop)", loop(), plain())
            bound_ms, by = _bound(2 * 48 * n, n * _pow_ops(digits))
            row = {"width": n, "exponent": names.get(e, hex(e)), "launches": launches,
                   "ms": _time_ms(kern, reps), "loop_ms": _time_ms(loop, 1),
                   "wall_ms": _wall_ms(kern, reps), "loop_wall_ms": _wall_ms(loop, 3),
                   "plain_ms": _wall_ms(plain, 1), "bound_ms": bound_ms, "bound_by": by,
                   "max_abs_err": err}
            timed.append(row)
            log(f"kernel {label}: bit-equal to plain (max_abs_err 0); {launches} launches on the "
                f"main path; {row['ms'] * 1e3:.1f} us/launch (host wall {row['wall_ms'] * 1e3:.1f}"
                f" us) against the per-step loop's {row['loop_ms'] * 1e3:.1f} us of device time "
                f"(host wall {row['loop_wall_ms'] * 1e3:.1f} us); plain {row['plain_ms']:.1f} ms; "
                f"bound {bound_ms * 1e3:.2f} us ({by})")
        if not timed:
            continue
        top = timed[0]
        rows[("fe_pow", layout)] = {
            "name": f"fe_pow<{layout}>", "route": "cuda", "source": CP.KERNELS["fe_pow"].source,
            "replaces": CP.KERNELS["fe_pow"].site(layout), "launches": 0, "library_ms": None,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "width", "exponent", "loop_ms", "loop_wall_ms")},
            "by_width": [{k: v for k, v in r.items() if k not in ("bound_by", "max_abs_err")}
                         for r in timed]}
    torch.cuda.synchronize()
    return rows


def pow_shape() -> str:
    """fe_pow's launch shape, from the constants of the kernel source."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    block, lanes, most, table = (
        int(re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1))
        for name in ("kPowBlock", "kPowLanes", "kPowSplitMax", "kPowTable"))
    return (f"fe_pow: {block} threads a block, {lanes} lanes a product up to {most} elements "
            f"(one past it), a table of {table} entries split over them: "
            f"{table * 48 // lanes * block} B of dynamic shared memory a block "
            f"({table * 48 * block} B at one lane)")


# ---------------------------------------------------------------------------
# Scalar multiplication: pt_mul_shared and pt_mul_windowed, one launch each
# ---------------------------------------------------------------------------

U2 = PF.X_ABS * PF.X_ABS               # the G1 subgroup check's [u²]P
# the gates before the slot, at 16 lanes with every edge lane: (kernel, E,
# width, k or windows); k = 5 takes an order-3 lane through P + P (P, 2P,
# 4P = P, + P) and k = 1 through no step; at 15 lanes pt_mul_shared<1>'s
# last warp holds one real point, of order 3 in one case, beside a padded
# one. pt_mul_windowed<1> runs on the DKG's path (phase 8), held and timed
# at its widths there
MUL_GATE = (("pt_mul_shared", 1, 16, U2), ("pt_mul_shared", 2, 16, PC.H_EFF_G2),
            ("pt_mul_shared", 1, 16, 1), ("pt_mul_shared", 1, 16, 5),
            ("pt_mul_shared", 1, 15, 5), ("pt_mul_shared", 2, 16, 5),
            ("pt_mul_windowed", 1, 16, 4), ("pt_mul_windowed", 2, 16, 4),
            # the bulk verify's G2 subgroup check, [u]P at a chunk's buckets
            ("pt_mul_shared", 2, 512, PF.X_ABS), ("pt_mul_shared", 2, 1024, PF.X_ABS))
MUL_SCALARS = {PC.H_EFF_G2: "H_EFF_G2", U2: "X_ABS^2", PF.X_ABS: "X_ABS"}


def _mul_any(ops, pt, k: int):
    """k·pt by double-and-add, k not reduced mod r."""
    acc = PC.jac_infinity(ops)
    for bit in bin(k)[2:]:
        acc = PC.jac_double(ops, acc)
        if bit == "1":
            acc = PC.jac_add(ops, acc, pt)
    return acc


def order3_g1():
    """A point of order 3 on G1's curve y² = x³ + 4 (its cofactor
    (X_ABS + 1)²/3 has the factor 3): [r·h/3]Q for the first curve point Q
    whose multiple is not ∞."""
    h = (PF.X_ABS + 1) ** 2 // 3
    x = 1
    while True:
        y = PF.fq_sqrt((x ** 3 + 4) % PF.P)
        if y is not None:
            pt = _mul_any(PC.FqOps, (x, y, 1), PF.R * h // 3)
            if not PC.jac_is_infinity(PC.FqOps, pt):
                if not PC.jac_is_infinity(PC.FqOps, _mul_any(PC.FqOps, pt, 3)):
                    raise SystemExit("order3_g1: the point's order is not 3")
                return pt
        x += 1


_MUL_POOL: dict = {}


def _mul_lanes(E: int) -> list:
    """16 Jacobian points: lane 0 ∞ (zeros, as the planes' padding), lanes 1
    and 5 a point of order 3, lane 2 a G1 point plus it (off the subgroup,
    with an order-3 component), the rest seeded multiples of the generator;
    at E = 2 the G1 edge points embedded in Fq2 (c1 = 0, as the MSM's pk
    lanes)."""
    if E not in _MUL_POOL:
        rng = random.Random(f"mul lanes {E}")
        ops = PC.FqOps if E == 1 else PC.Fq2Ops
        gen = PC.g1_generator() if E == 1 else PC.g2_generator()
        pts = [PC.jac_mul(ops, gen, rng.randrange(1, PF.R)) for _ in range(16)]
        o3 = order3_g1()
        mixed = PC.jac_add(PC.FqOps, PC.jac_mul(PC.FqOps, PC.g1_generator(), 7), o3)

        def fit(pt):
            return pt if E == 1 else tuple((c, 0) for c in pt)

        pts[0] = (0, 0, 0) if E == 1 else ((0, 0),) * 3
        pts[1] = pts[5] = fit(o3)
        pts[2] = fit(mixed)
        _MUL_POOL[E] = pts
    return _MUL_POOL[E]


def _mul_digits(n: int, nwin: int, seed: str, edges: bool) -> torch.Tensor:
    """(nwin, n) seeded 4-bit digits; with edges (n > 5): lane 3 all zero,
    lane 4 k = 1, lane 5 (the order-3 point) 1 then 1, so that its second
    window adds P to 16P = P (the P+P double)."""
    rng = random.Random(seed)
    d = torch.tensor([[rng.randrange(16) for _ in range(n)] for _ in range(nwin)],
                     dtype=torch.uint8)
    if edges and n > 5:
        d[:, 3] = 0
        d[:, 4] = 0
        d[-1, 4] = 1
        d[:2, 5] = 1
    return d


def _mul_cases(name: str, E: int, n: int, arg: int, device) -> list:
    """[(label, (X, Y, Z), digits or None)] at width n: the edge lanes
    (cycling through _mul_lanes; below 16 lanes from lane 0, ∞, and from
    lane 1, order 3, and at an odd width also so that lane 1 is the last),
    and last the case that is timed: general lanes only,
    seeded multiples of the generator and random digits, as on the main
    path, where no point of small order reaches a kernel (no P+P double)."""
    pool = _mul_lanes(E)
    if n >= 16:
        cases = [("edge lanes", [i % 16 for i in range(n)])]
    else:
        los = (0, 1) if n % 2 == 0 else (0, 1, (2 - n) % 16)
        cases = [(f"edge lanes from {lo}", [(lo + i) % 16 for i in range(n)]) for lo in los]
    cases.append(("general lanes", [6 + i % 10 for i in range(n)]))
    out = []
    for label, lanes in cases:
        planes = tuple(CV.port_from_ints([pool[i][c] for i in lanes], E, device)
                       for c in range(3))
        digits = (_mul_digits(n, arg, f"{name}<{E}> {n} {arg} {label}",
                              label != "general lanes").to(device)
                  if name == "pt_mul_windowed" else None)
        out.append((label, planes, digits))
    return out


def mul_kernel(name: str, E: int, pts, arg):
    """The wrapper: one pt_mul_shared / pt_mul_windowed launch."""
    if name == "pt_mul_shared":
        return CP.shared_mul(*pts, arg, E)
    return CP.scalar_mul_windowed(*pts, arg, E)


def mul_plain(name: str, E: int, pts, arg):
    if name == "pt_mul_shared":
        return C.pt_mul_shared_plain(*pts, arg, E)
    return C.pt_mul_windowed_plain(*pts, arg, E)


def mul_loop(lib, name: str, E: int, pts, arg):
    """The per-step loop the kernel replaces, launched from `lib` outside the
    counters: cuda_plane.shared_mul and scalar_mul_windowed as they were, a
    pt_double / pt_add launch per step (and for the windowed product a torch
    gather of the selected entries per window)."""
    def dbl(p):
        return CP.call(lib, "pt_double", E, p, 3)

    def add(p, q):
        return CP.call(lib, "pt_add", E, (*p, *q), 3)

    if name == "pt_mul_shared":
        return shared_steps(lib, E, pts, pts, bin(arg)[3:])
    zero = torch.zeros_like(pts[0])
    tab = [(zero, zero, zero), tuple(pts)]
    for k in range(2, 16):
        tab.append(dbl(tab[k // 2]) if k % 2 == 0 else add(tab[k - 1], pts))
    T = [torch.stack([t[c] for t in tab]) for c in range(3)]
    n = pts[0].shape[-1]
    idx_all = arg.to(torch.int64)
    acc = (zero, zero, zero)
    for w in range(idx_all.shape[0]):
        for _ in range(4):
            acc = dbl(acc)
        idx = idx_all[w].view(1, 1, 1, n).expand(1, E, F.LIMBS, n)
        acc = add(acc, [t.gather(0, idx)[0] for t in T])
    return acc


def shared_steps(lib, E: int, acc, P, bits: str):
    """pt_mul_shared's loop over some of its bits from acc: a pt_double
    launch per bit, then a pt_add of P where the bit is 1."""
    for bit in bits:
        acc = CP.call(lib, "pt_double", E, acc, 3)
        if bit == "1":
            acc = CP.call(lib, "pt_add", E, (*acc, *P), 3)
    return acc


def loop_device_ms(lib, name: str, E: int, pts, a) -> float:
    """Device ms of mul_loop back to back; pt_mul_shared's loop timed in
    chunks of 256 bits (each chunk's start computed first), so that no timed
    run holds more launches than the launch queue takes (_time_ms)."""
    if name != "pt_mul_shared":
        return _time_ms(lambda: mul_loop(lib, name, E, pts, a), 1)
    bits, ms, acc = bin(a)[3:], 0.0, tuple(pts)
    for lo in range(0, len(bits), 256):
        chunk = bits[lo:lo + 256]
        ms += _time_ms(lambda acc=acc, chunk=chunk: shared_steps(lib, E, acc, pts, chunk), 1)
        acc = shared_steps(lib, E, acc, pts, chunk)
    return ms


def mul_steps(name: str, arg: int) -> tuple:
    """(doubles, adds) of one lane's chain."""
    if name == "pt_mul_shared":
        return arg.bit_length() - 1, bin(arg).count("1") - 1
    return 7 + 4 * arg, 7 + arg


def check_mul(device, cases: dict, reps: int = 0) -> dict:
    """pt_mul_shared<E> and pt_mul_windowed<E> bit for bit (X, Y, Z words)
    against their plain versions (the same loop over the plain point
    functions) at each case (kernel, E, width, k or windows) -> the main
    path's launches, on _mul_cases' inputs. With reps each case is also
    timed on its general lanes, beside the per-step loop it replaces
    (device us back to back,
    and the loop's synchronised host wall); returns per (kernel, E) the JSON
    row of its most launched case, with every case in by_width. Bound: the
    sum of the steps' bounds, by operations (an add counted without the
    P+P double), against the planes' and digits' bytes."""
    rows = {}
    lib = CP._library()
    for (name, E) in (("pt_mul_shared", 1), ("pt_mul_shared", 2), ("pt_mul_windowed", 1),
                      ("pt_mul_windowed", 2)):
        timed = []
        for (nm, e, n, arg), launches in sorted(cases.items(), key=lambda kv: -kv[1]):
            if (nm, e) != (name, E):
                continue
            what = f"k={MUL_SCALARS.get(arg, arg)}" if name == "pt_mul_shared" else f"windows={arg}"
            cases_n = _mul_cases(name, E, n, arg, device)
            for i, (label, pts, digits) in enumerate(cases_n):
                a = arg if digits is None else digits
                tag = f"{name}<{E}> n={n} {what} ({label})"
                got = mul_kernel(name, E, pts, a)
                err = _hold(tag, got, mul_plain(name, E, pts, a))
                if i < len(cases_n) - 1 or not reps:
                    log(f"kernel {tag}: bit-equal to plain (X, Y, Z words)")
                    continue
                _hold(f"{tag} (the per-step loop)", mul_loop(lib, name, E, pts, a), got)
                dbl, add = mul_steps(name, arg)
                ops = n * (dbl * point_ops("pt_double", E) + add * point_ops("pt_add", E))
                nbytes = 2 * 3 * E * 48 * n + (0 if digits is None else digits.numel())
                bound_ms, by = _bound(nbytes, ops)
                row = {"width": n, ("scalar_bits" if digits is None else "windows"):
                       arg.bit_length() if digits is None else arg, "launches": launches,
                       "steps": dbl + add,
                       "ms": _time_ms(lambda: mul_kernel(name, E, pts, a), reps),
                       "loop_ms": loop_device_ms(lib, name, E, pts, a),
                       "wall_ms": _wall_ms(lambda: mul_kernel(name, E, pts, a), reps),
                       "loop_wall_ms": _wall_ms(lambda: mul_loop(lib, name, E, pts, a), 2),
                       "plain_ms": _wall_ms(lambda: mul_plain(name, E, pts, a), 1),
                       "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
                timed.append(row)
                log(f"kernel {tag}: bit-equal to plain (max_abs_err 0); {launches} launches on "
                    f"the main path; {row['ms'] * 1e3:.1f} us/launch (host wall "
                    f"{row['wall_ms'] * 1e3:.1f} us) against the per-step loop's "
                    f"{row['loop_ms'] * 1e3:.1f} us of device time (host wall "
                    f"{row['loop_wall_ms'] * 1e3:.1f} us, {dbl + add} steps); plain "
                    f"{row['plain_ms']:.1f} ms; bound {bound_ms * 1e3:.2f} us ({by})")
        if not timed:
            continue
        top = timed[0]
        rows[(name, E)] = {
            "name": f"{name}<{E}>", "route": "cuda", "source": CP.KERNELS[name].source,
            "replaces": CP.KERNELS[name].site(E), "launches": 0, "library_ms": None,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "width", "loop_ms", "loop_wall_ms")},
            "by_width": [{k: v for k, v in r.items() if k not in ("bound_by", "max_abs_err")}
                         for r in timed]}
    torch.cuda.synchronize()
    return rows


def mul_cases(cases: dict) -> dict:
    """The composites' cases of a run, from path_counts()["cases"]: (kernel,
    E, width, k or windows) -> launches."""
    return {(name, E, n, arg): c for name in ("pt_mul_shared", "pt_mul_windowed")
            for (E, n, arg), c in cases[name].items()}


# ---------------------------------------------------------------------------
# Slot
# ---------------------------------------------------------------------------


def shamir_split(secret: int, total: int, threshold: int, rng: random.Random) -> dict[int, int]:
    coeffs = [secret] + [rng.randrange(PF.R) for _ in range(threshold - 1)]
    shares = {}
    for i in range(1, total + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * i + c) % PF.R
        shares[i] = acc
    return shares


def _pubkey(sk: int) -> bytes:
    return native.pubkey(sk.to_bytes(32, "big"))


def _sign(sk: int, msg: bytes) -> bytes:
    return native.sign(sk.to_bytes(32, "big"), msg)


def _lincomb(sigs: list[bytes], lams: list[int]) -> bytes:
    out = (ctypes.c_uint8 * 96)()
    rc = native.load_library().ct_lincomb_g2(b"".join(sigs), b"".join(l.to_bytes(32, "big") for l in lams),
                                             len(sigs), out)
    if rc != 0:
        raise SystemExit("native ct_lincomb_g2 rejected a partial")
    return bytes(out)


def gen_cluster(pool: ThreadPoolExecutor):
    """The fixed probe: seed 99, 1000 validators, 4 of 6 shares sign 0x42*32."""
    rng = random.Random(99)
    secrets_, jobs = [], []
    for _ in range(N_VALIDATORS):
        sk = rng.randrange(1, PF.R)
        shares = shamir_split(sk, NUM_SHARES, THRESHOLD, rng)
        ids = sorted(rng.sample(range(1, NUM_SHARES + 1), THRESHOLD))
        secrets_.append(sk)
        jobs.append({i: shares[i] for i in ids})
    pubkeys = list(pool.map(_pubkey, secrets_))
    return sign_cluster(pool, jobs, [MSG] * N_VALIDATORS), pubkeys, jobs


def sign_cluster(pool: ThreadPoolExecutor, jobs, msgs) -> list[dict]:
    """Validator v's partial signatures over msgs[v], one per share it holds."""
    flat = [(v, i, s) for v, job in enumerate(jobs) for i, s in job.items()]
    sigs = list(pool.map(lambda t: _sign(t[2], msgs[t[0]]), flat))
    batches = [dict() for _ in range(len(jobs))]
    for (v, i, _s), sig in zip(flat, sigs):
        batches[v][i] = sig
    return batches


def off_curve_x(sig: bytes) -> bytes:
    """A compressed G2 encoding with x < p that is on no curve point."""
    body = bytearray(sig)
    while True:
        body[95] = (body[95] + 1) % 256
        x1 = int.from_bytes(bytes([body[0] & 0x1F]) + bytes(body[1:48]), "big")
        x0 = int.from_bytes(bytes(body[48:]), "big")
        y2 = PF.fq2_add(PF.fq2_mul(PF.fq2_sqr((x0, x1)), (x0, x1)), PC.B_G2)
        if PF.fq2_sqrt(y2) is None:
            return bytes(body)


def first_slot_steps(batches, pubkeys, datas, device, pk_cache=None, h2c=None,
                     verify: str = "device") -> list:
    """One slot step by step: plane_agg.fused_slot's step hook for the
    dispatch, then readback, emit and the verify on the given rung. Fresh
    caches (the default) make it a first slot (pk-plane miss, H(m) hashed);
    caches a slot has filled, a steady one. [(step, launches, ms)]: each
    step's launches from the wrapper counters and its wall time up to a
    synchronise."""
    pk_cache = PA.PkPlaneCache() if pk_cache is None else pk_cache
    h2c = PA.H2CCache() if h2c is None else h2c
    rows, last = [], [0.0]

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        ms = (time.perf_counter() - last[0]) * 1e3
        rows.append((name, sum(sum(k.launches.values()) for k in CP.KERNELS.values()), ms))
        CP.reset_counts()
        last[0] = time.perf_counter()

    CP.reset_counts()
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    layout = PA.layout_slots(batches)
    mark("slot layout (host)")
    state = PA.fused_slot(layout, pubkeys, datas, device, pk_cache, mark=mark)
    if state[0] != "pending":
        raise SystemExit(f"step run: the slot ended as {state[0]!r}")
    hstate = PA.readback(state)
    mark("readback")
    _out, S, pts = PA.host_emit(hstate, device)
    mark("emit: bytes + host folds")
    misses = h2c.misses
    if not PA.pairing_finish(S, pts, h2c, {}, verify, device):
        raise SystemExit(f"step run: {verify} verify False on valid aggregates")
    mark(f"{verify} verify (H(m) {'hashed' if h2c.misses > misses else 'cached'})")
    return rows


# a slot's dispatch by step (plane_agg.fused_slot's marks: parse, pk plane,
# randomizers, G2 decompression, sweep + combine, affine, MSM + group sums:
# one pt_mul_windowed<2> and one pt_reduce_groups<2> call): the exact counts
# of tests/test_torch_slice.py; a steady slot's pk plane is a cache hit
DISPATCH_STEPS = {"first": [0, 12, 0, 19, 4, 8, 2], "steady": [0, 0, 0, 19, 4, 8, 2]}


def slot_steps(batches, pubkeys, datas, device, total: int) -> None:
    """Log the steps of a first and a steady slot on each verify rung, and
    the dispatch's launches by step, which must be DISPATCH_STEPS; the
    first device-verified slot's launches must add up to `total`, the first
    slot's count."""
    for verify in ("device", "native"):
        pk_cache, h2c = PA.PkPlaneCache(), PA.H2CCache()
        for kind in ("first", "steady"):
            rows = first_slot_steps(batches, pubkeys, datas, device, pk_cache, h2c, verify)
            for name, n, ms in rows:
                log(f"step ({kind} slot, verify={verify}) {name}: {n} launches, {ms:.2f} ms "
                    f"(synchronised wall)")
            dispatch = [n for _name, n, _ms in rows[1:8]]
            log(f"dispatch launches by step ({kind} slot, verify={verify}): "
                + ", ".join(f"{name} {n}" for name, n, _ms in rows[1:8])
                + f"; {sum(dispatch)} in all")
            if dispatch != DISPATCH_STEPS[kind]:
                raise SystemExit(f"the {kind} slot's dispatch launched {dispatch} by step, "
                                 f"not {DISPATCH_STEPS[kind]}")
            if (verify, kind) == ("device", "first") and sum(n for _, n, _ in rows) != total:
                raise SystemExit(f"steps launched {sum(n for _, n, _ in rows)}, the slot {total}")


def _width_text(widths: dict) -> str:
    return ", ".join(f"{name}<{E}> n={n}: {c}" for name, counts in widths.items()
                     for (E, n), c in sorted(counts.items()))


# kernels the sigagg paths (the slot, the bulk verify) do not launch: every
# point double and every G1 add run inside pt_mul_shared / pt_mul_windowed
# (pt_add<2> still adds the combine and hash-to-G2's q0 + q1), the windowed
# product and the MSM's group sums run at E = 2 only (the MSM's G1 lanes
# embedded in Fq2), and the group reduction at E = 1 serves the DKG (phase 8)
OFF_PATH = (("pt_double", 1), ("pt_double", 2), ("pt_add", 1), ("pt_mul_windowed", 1),
            ("pt_reduce_groups", 1))


def run_slot(impl: TorchImpl, batches, pubkeys, datas, pool) -> dict:
    main_path = [(k, E) for k in CP.KERNELS for E in CP.KERNELS[k].variants]
    # one slot of the main path, pk-plane miss included: counters at 0
    # just before, read just after
    CP.reset_counts()
    t0 = time.perf_counter()
    aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
    warm_s = time.perf_counter() - t0
    launches = {(k, E): CP.KERNELS[k].launches[E] for k, E in main_path}
    if not ok:
        raise SystemExit("slot verdict False on valid aggregates (warm run)")
    missing = [f"{k}<{E}>" for (k, E), c in launches.items() if c == 0 and (k, E) not in OFF_PATH]
    if missing:
        raise SystemExit(f"main path launched no {missing}")
    off = [f"{k}<{E}>={launches[k, E]}" for k, E in OFF_PATH if launches[k, E]]
    if off:
        raise SystemExit(f"main path launched {off}, which should run inside pt_mul_shared / "
                         f"pt_mul_windowed or not at all")
    log(f"slot warm (first: pk plane decoded, H(m) hashed on the device, device verify): "
        f"{warm_s:.3f} s, verify {impl.last_times.verify:.4f} s; launches "
        + ", ".join(f"{k}<{E}>={c}" for (k, E), c in launches.items()))
    counts = path_counts()
    widths = counts["widths"]
    log(f"slot warm point launches by width: "
        f"{_width_text({k: widths[k] for k in POINT_KERNELS})}")

    times, shares = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
        dt = time.perf_counter() - t0
        times.append(dt)
        shares.append(impl.last_times.verify / dt)
        if not ok:
            raise SystemExit("slot verdict False on valid aggregates")
    med = statistics.median(times)
    log(f"slot 1000x4-of-6 (verify={impl.rung}): median {med:.4f} s, runs "
        + ", ".join(f"{t:.4f}" for t in times)
        + f"; pairing share {statistics.median(shares):.4f}; phases of the last run: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in vars(impl.last_times).items()))

    def oracle(batch):
        ids = sorted(batch)
        return _lincomb([batch[i] for i in ids], PF.lagrange_coefficients_at_zero(ids))

    want = list(pool.map(oracle, batches))
    same = sum(bytes(a) == w for a, w in zip(aggs, want))
    if same != N_VALIDATORS:
        raise SystemExit(f"only {same}/{N_VALIDATORS} aggregates match native ct_lincomb_g2")
    log(f"aggregates: {same}/{N_VALIDATORS} byte-identical to native ct_lincomb_g2")
    slot_steps(batches, pubkeys, datas, impl.device, sum(launches.values()))

    # a tampered partial: validator 17's first partial replaced by validator 18's
    v17, v18 = 17 % len(batches), 18 % len(batches)
    tampered = [dict(b) for b in batches]
    first = sorted(tampered[v17])[0]
    tampered[v17][first] = batches[v18][sorted(batches[v18])[0]]
    _aggs, ok_t = impl.threshold_aggregate_verify_batch(tampered, pubkeys, datas)
    if ok_t:
        raise SystemExit("tampered partial verified True")
    log("tampered partial: verdict False")

    # bad encodings raise the reference's ValueError texts
    flag = [dict(b) for b in batches]
    i0 = sorted(flag[5])[0]
    flag[5][i0] = bytes([flag[5][i0][0] & 0x7F]) + flag[5][i0][1:]
    bad = [dict(b) for b in batches]
    v300 = 300 % len(batches)
    i1 = sorted(bad[v300])[1]
    bad[v300][i1] = off_curve_x(bad[v300][i1])
    layout = PA.layout_slots(bad)
    k = layout[0].index(bad[v300][i1])
    for case, want_text in ((flag, "uncompressed G2 not supported"),
                            (bad, f"invalid G2 point at index {k}")):
        try:
            impl.threshold_aggregate_verify_batch(case, pubkeys, datas)
        except ValueError as exc:
            if str(exc) != want_text:
                raise SystemExit(f"bad encoding raised {exc!r}, expected {want_text!r}")
        else:
            raise SystemExit(f"bad encoding did not raise ({want_text})")
        log(f"bad encoding: ValueError({want_text!r})")
    log(f"pairing_path (pairs per rung): {impl.pairing_path}")
    return {"launches": launches, **counts,
            "median_s": med,
            "times_s": times, "pairing_share": statistics.median(shares), "tampered": tampered}


def native_twin(batches, pubkeys, datas, tampered) -> None:
    """The same slots with verify="native": the same verdicts, and the
    native slot's median and verify phase beside the device's."""
    impl = TorchImpl(verify="native")
    _aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
    times, verifies = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
        times.append(time.perf_counter() - t0)
        verifies.append(impl.last_times.verify)
        if not ok:
            raise SystemExit("native rung: verdict False on valid aggregates")
    _aggs, ok_t = impl.threshold_aggregate_verify_batch(tampered, pubkeys, datas)
    if ok_t:
        raise SystemExit("native rung: tampered partial verified True")
    log(f"slot 1000x4-of-6 (verify=native): median {statistics.median(times):.4f} s, runs "
        + ", ".join(f"{t:.4f}" for t in times) + "; verify phase "
        + ", ".join(f"{v:.4f}" for v in verifies) + " s; verdicts True / tampered False, "
        "as the device rung's")


def slot_pairs(impl: TorchImpl, batches, pubkeys, datas):
    """(S, live) of one slot, from the slot's own dispatch/readback/emit."""
    layout = PA.layout_slots(batches)
    state = PA.fused_slot(layout, pubkeys, datas, impl.device, impl.pk_cache)
    _out, S, pts = PA.host_emit(PA.readback(state), impl.device)
    live = [(bytes(m), P) for m, P in pts if not PC.jac_is_infinity(PC.FqOps, P)]
    return S, live


# a steady 2-pair device verify's rows launches (ops/pairing.py: 4,778, of
# which fe_mul_rows<1> 70, fe_mul_rows<2> 699, fe_add_rows 4,008 (1,519 of
# them split, 920 at n_add = 0) and fe_pow<rows> 1), with a margin
STEADY_VERIFY_MAX_LAUNCHES = 4800


def verify_launches(impl: TorchImpl, S, live, label: str) -> dict:
    """Launches and synchronised wall of one device verify by kernel and E."""
    CP.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = PA.pairing_finish(S, live, impl.h2c, {}, "device", impl.device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {f"{k}<{E}>" if len(v.variants) > 1 else k: v.launches[E]
              for k, v in CP.KERNELS.items() for E in v.variants if v.launches[E]}
    if not ok:
        raise SystemExit(f"{label} device verify False on valid aggregates")
    splits = CP.KERNELS["fe_add_rows"].cases
    log(f"{label} device verify: {dt:.4f} s, {sum(counts.values())} launches: "
        + ", ".join(f"{k}={c}" for k, c in counts.items())
        + f" (fe_add_rows split: {sum(c for (_E, _n, k), c in splits.items() if k)}, at n_add "
        f"0: {sum(c for (_E, _n, k), c in splits.items() if not k)})")
    return counts


def verify_host_ops(impl: TorchImpl, S, live) -> None:
    """The PyTorch ops the host dispatches in one more steady device verify,
    by name (top-level CPU events of torch.profiler; the kernel launches go
    through ctypes and are counted by the wrappers). Untimed."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PA.pairing_finish(S, live, impl.h2c, {}, "device", impl.device)
        torch.cuda.synchronize()
    ops = collections.Counter(e.name for e in prof.events() if e.cpu_parent is None)
    log(f"steady device verify host ops: {sum(ops.values())} PyTorch ops, "
        + ", ".join(f"{k} {v}" for k, v in ops.most_common(8)))


def committee_slot(pool, jobs, pubkeys) -> dict:
    """1000 x 4-of-6 over 64 committee roots: device verify against the
    native rung, the 64 device H(m) against ct_hash_to_g2, then the chunked
    1,040-pair check built from this slot's 65 pairs. Returns what the
    counters hold of all of it (path_counts), so that every case it
    launched is held against its plain version."""
    k = len(COMMITTEE_MSGS)
    datas = [COMMITTEE_MSGS[v % k] for v in range(N_VALIDATORS)]
    t0 = time.perf_counter()
    batches = sign_cluster(pool, jobs, datas)
    log(f"committee probe: {N_VALIDATORS} validators over {k} messages signed natively in "
        f"{time.perf_counter() - t0:.1f} s")
    impl, native_impl = TorchImpl(), TorchImpl(verify="native")
    CP.reset_counts()
    t0 = time.perf_counter()
    _aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
    first = time.perf_counter() - t0
    rows_launches = (sum(sum(CP.KERNELS[k].launches.values())
                         for k in ("fe_mul_rows", "fe_add_rows"))
                     + CP.KERNELS["fe_pow"].launches["rows"])
    widths = {name: dict(CP.KERNELS[name].widths) for name in POINT_KERNELS}
    _aggs, ok_n = native_impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
    if not (ok and ok_n):
        raise SystemExit(f"committee slot: device verdict {ok}, native verdict {ok_n}")
    log(f"committee slot (first, {k} H(m) hashed on the device): {first:.3f} s, verify "
        f"{impl.last_times.verify:.4f} s, {rows_launches} rows-kernel launches; point "
        f"launches by width: {_width_text(widths)}; pairing_path {impl.pairing_path}")
    times = []
    for _ in range(3):
        _aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
        times.append(impl.last_times.verify)
        if not ok:
            raise SystemExit("committee slot: verdict False on valid aggregates")
    log(f"committee slot steady device verify ({k + 1} pairs): "
        + ", ".join(f"{t:.4f}" for t in times) + f" s, median {statistics.median(times):.4f} s")
    same = sum(impl.h2c.entry(m)[0] == native.hash_to_g2(m) for m in COMMITTEE_MSGS)
    if same != k:
        raise SystemExit(f"only {same}/{k} device H(m) match native ct_hash_to_g2")
    log(f"committee slot: {k}/{k} device H(m) byte-identical to native ct_hash_to_g2")
    v100, v101 = 100 % len(batches), 101 % len(batches)
    tampered = [dict(b) for b in batches]
    first_id = sorted(tampered[v100])[0]
    tampered[v100][first_id] = batches[v101][sorted(batches[v101])[0]]
    _a, ok_t = impl.threshold_aggregate_verify_batch(tampered, pubkeys, datas)
    _a, ok_tn = native_impl.threshold_aggregate_verify_batch(tampered, pubkeys, datas)
    if ok_t or ok_tn:
        raise SystemExit(f"committee slot tampered: device {ok_t}, native {ok_tn}")
    log("committee slot tampered partial: device False, native False")

    # the chunked check: this slot's k + 1 pairs x 16 (1,040 pairs at k = 64:
    # one full chunk and 16 pairs)
    S, live = slot_pairs(impl, batches, pubkeys, datas)
    px, py, qx, qy = PA.pairing_rows(S, live, impl.h2c, impl.device)
    if px.shape[0] != k + 1:
        raise SystemExit(f"committee slot has {px.shape[0]} pairs, expected {k + 1}")
    rep = [t.repeat(16, *([1] * (t.dim() - 1))) for t in (px, py, qx, qy)]
    n = rep[0].shape[0]
    t0 = time.perf_counter()
    ok_c = PR.pairing_check_planes(*rep)
    dt = time.perf_counter() - t0
    # the last message pair (pair n - 1 is the S pair) takes H(m_0)
    last = n - 2
    qx_t, qy_t = rep[2].clone(), rep[3].clone()
    qx_t[last], qy_t[last] = qx[0], qy[0]
    ok_ct = PR.pairing_check_planes(rep[0], rep[1], qx_t, qy_t)
    if not ok_c or ok_ct:
        raise SystemExit(f"chunked check: valid {ok_c}, tampered last chunk {ok_ct}")
    spans = [hi - lo for lo, hi in PR.buckets.chunk_spans(n, PR.MAX_PAIR_TILE)]
    log(f"chunked check {n} pairs (chunks {spans}): True in {dt:.3f} s; pair {last} of the "
        "last chunk tampered gives False")
    return path_counts()


# ---------------------------------------------------------------------------
# Bulk verify (phase 6): peers' partial-signature sets through verify_batch
# ---------------------------------------------------------------------------

BULK_VALIDATORS, BULK_PEERS, BULK_ATTESTERS = 500, 5, 400
# mixed duties: validators 0-399 sign an attestation root, 400-499 a
# sync-committee root
ATT_ROOT, SYNC_ROOT = b"\xa7" * 32, b"\x5c" * 32
INF96, INF48 = b"\xc0" + bytes(95), b"\xc0" + bytes(47)
# G2's cofactor: its smallest prime is 13 (13^2 | h2); it has no factor 3
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5
# the bulk verify's launches by step (plane_agg.rlc_verify_dispatch's
# marks), two message groups, at a chunk bucket of up to 1,024: a pk
# chunk's decode on a miss (G1 decompression 7, subgroup check 5) and each
# chunk's G2 decompression 19, subgroup check 5 (pt_mul_shared<2> at X_ABS,
# a level of negations, 3 product levels) and MSM 2 (one
# pt_mul_windowed<2> and one pt_reduce_groups<2> call over the signatures
# and both groups' pk lanes): the exact counts of
# tests/test_torch_verify_chunks.py
VERIFY_CHUNK_LAUNCHES = {
    "pk plane": {"fe_mul": {1: 7}, "fe_addsub": {1: 3}, "fe_pow": {"plane": 1},
                 "pt_mul_shared": {1: 1}},
    "chunk": {"fe_mul": {1: 9, 2: 5}, "fe_addsub": {1: 5, 2: 2}, "fe_pow": {"plane": 2},
              "pt_mul_shared": {2: 1}, "pt_mul_windowed": {2: 1}, "pt_reduce_groups": {2: 1}},
}


def bulk_sets(pool):
    """500 validators at 4-of-6 from the probe's seed (99); peer i (1-5)
    holds share i of each: its inbound set is the triples (share i's
    pubkey, validator v's root, share i's partial over it) for every v.
    Returns {peer: (pks, msgs, sigs)}."""
    rng = random.Random(99)
    shares = [shamir_split(rng.randrange(1, PF.R), NUM_SHARES, THRESHOLD, rng)
              for _ in range(BULK_VALIDATORS)]
    msgs = [ATT_ROOT if v < BULK_ATTESTERS else SYNC_ROOT for v in range(BULK_VALIDATORS)]
    jobs = [(i, v) for i in range(1, BULK_PEERS + 1) for v in range(BULK_VALIDATORS)]
    pks = list(pool.map(lambda t: _pubkey(shares[t[1]][t[0]]), jobs))
    sigs = list(pool.map(lambda t: _sign(shares[t[1]][t[0]], msgs[t[1]]), jobs))
    n = BULK_VALIDATORS
    return {i: (pks[(i - 1) * n:i * n], list(msgs), sigs[(i - 1) * n:i * n])
            for i in range(1, BULK_PEERS + 1)}


def off_subgroup_g2(sig: bytes) -> tuple:
    """Two G2 encodings on the curve and outside the subgroup, each checked
    natively: a point decompressed from an x = (x0, 1), not cofactor-cleared,
    and `sig` plus a point of order 13 made from such a point (the curve's
    group exponent is r·h2/13, so [r·h2/13²]P has order 13 where it is not
    ∞)."""
    x0 = 1
    while True:
        x = (x0, 1)
        y = PF.fq2_sqrt(PF.fq2_add(PF.fq2_mul(PF.fq2_sqr(x), x), PC.B_G2))
        if y is not None:
            raw = (x, y, (1, 0))
            t13 = _mul_any(PC.Fq2Ops, raw, PF.R * G2_COFACTOR // 169)
            if not PC.jac_is_infinity(PC.Fq2Ops, t13):
                break
        x0 += 1
    if not PC.jac_is_infinity(PC.Fq2Ops, _mul_any(PC.Fq2Ops, t13, 13)):
        raise SystemExit("off_subgroup_g2: the point's order is not 13")
    mixed = PC.jac_add(PC.Fq2Ops, PC.to_jacobian(PC.Fq2Ops, g2_affine_from_bytes(sig)), t13)
    out = g2_to_bytes(raw), g2_to_bytes(mixed)
    if any(native.g2_check(b) for b in out):
        raise SystemExit("off_subgroup_g2: native ct_g2_check accepts a point built outside "
                         "the subgroup")
    return out


def _coefs(n: int, seed: str) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(1, 1 << 64) for _ in range(n)]


def bulk_gates(sets, device) -> None:
    """One peer's set (500 triples, one 512-lane chunk) on both rungs of
    TorchImpl().verify_batch: valid True; the validator-137 triple's partial
    replaced by another share's, its signature infinity, a raw curve point
    or the partial plus an order-13 point, its flag byte cleared, its
    pubkey infinity: False; each verdict native ct_verify_batch's, and the
    altered triple's per-item ct_verify False. The burst (2,500 triples,
    chunks 1,024 / 1,024 / 452): valid True and a partial of the last chunk
    replaced False on both rungs, as natively."""
    pks, msgs, sigs = sets[1]
    k = 137 % len(pks)
    raw, mixed = off_subgroup_g2(sigs[k])
    cases = {"valid": (pks, sigs), "another share": (pks, sigs[:k] + [sets[2][2][k]] + sigs[k + 1:]),
             "infinity sig": (pks, sigs[:k] + [INF96] + sigs[k + 1:]),
             "raw curve point": (pks, sigs[:k] + [raw] + sigs[k + 1:]),
             "order-13 component": (pks, sigs[:k] + [mixed] + sigs[k + 1:]),
             "bad flag": (pks, sigs[:k] + [bytes([sigs[k][0] & 0x7F]) + sigs[k][1:]] + sigs[k + 1:]),
             "infinity pk": (pks[:k] + [INF48] + pks[k + 1:], sigs)}
    burst = [sum((list(sets[i][c]) for i in sets), []) for c in range(3)]
    last = len(burst[0]) - 2
    tampered = burst[2][:last] + [burst[2][last - 1]] + burst[2][last + 1:]
    n1, n5 = f"{len(pks):,} triples", f"{len(burst[0]):,} triples"
    runs = [(f"{n1}, {name}", p, msgs, sg, name == "valid") for name, (p, sg) in cases.items()]
    runs += [(f"{n5}, valid", burst[0], burst[1], burst[2], True),
             (f"{n5}, a partial of the last chunk replaced", burst[0], burst[1], tampered, False)]
    impls = {rung: TorchImpl(verify=rung) for rung in PA.VERIFY_PATHS}
    for label, p, m, sg, want in runs:
        nat = native.verify_batch(p, m, sg, _coefs(len(p), label))
        got = {rung: impl.verify_batch(p, m, sg) for rung, impl in impls.items()}
        if not (nat is want and all(v is want for v in got.values())):
            raise SystemExit(f"bulk verify {label}: device rung {got['device']}, native rung "
                             f"{got['native']}, native ct_verify_batch {nat}, expected {want}")
        extra = ""
        if not want and label.startswith(n1):
            if native.verify(p[k], m[k], sg[k]):
                raise SystemExit(f"bulk verify {label}: native ct_verify accepts the altered triple")
            extra = "; the altered triple's ct_verify False"
        log(f"bulk verify {label}: {want} on both rungs, as native ct_verify_batch{extra}")


def bulk_steps(triples, device, label: str) -> None:
    """The launches of each step of a first (pk planes decoded) and a
    steady verify_batch (dispatch by rlc_verify_dispatch's marks, then the
    fold and the device pairing), which must be VERIFY_CHUNK_LAUNCHES by
    chunk, and each step's synchronised wall."""
    pk_cache, h2c = PA.PkPlaneCache(), PA.H2CCache()
    n_chunks = len(PA.verify_chunks(len(triples[0])))
    for kind in ("first", "steady"):
        steps, last = [], [0.0]

        def mark(name: str) -> None:
            torch.cuda.synchronize()
            ms = (time.perf_counter() - last[0]) * 1e3
            steps.append((name, {k: {v: c for v, c in kern.launches.items() if c}
                                 for k, kern in CP.KERNELS.items() if sum(kern.launches.values())},
                          ms))
            CP.reset_counts()
            last[0] = time.perf_counter()

        CP.reset_counts()
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        state = PA.rlc_verify_dispatch(*triples, device, pk_cache, mark=mark)
        folded = PA.rlc_fold(state)
        mark("readback + host folds")
        if folded is None or not PA.pairing_finish(*folded, h2c, {}, "device", device):
            raise SystemExit(f"bulk steps {label}: False on valid triples")
        mark("device pairing")
        want_pk = {} if kind == "steady" else {
            name: {v: n_chunks * c for v, c in per.items()}
            for name, per in VERIFY_CHUNK_LAUNCHES["pk plane"].items()}
        if steps[0][1] != want_pk or any(c != VERIFY_CHUNK_LAUNCHES["chunk"]
                                         for _n, c, _ms in steps[1:1 + n_chunks]):
            raise SystemExit(f"bulk steps {label} ({kind}): launches by step "
                             f"{[(n, c) for n, c, _ms in steps]}, not VERIFY_CHUNK_LAUNCHES")
        log(f"bulk steps {label} ({kind}): " + "; ".join(
            f"{name} {sum(sum(v.values()) for v in c.values())} launches {ms:.2f} ms"
            for name, c, ms in steps) + " (synchronised wall; launches by chunk as on the CPU)")


# the per-triple verify's sizes (phase 6): a failed flush of three and of
# four 500-validator sets at flush_at 1,024 (as 1,000 validators' two), and
# a whole window of 5,000 triples
EACH_SIZES = (1500, 2000, 5000)
EACH_BAD_PK = 1500      # the size whose call also has two bad pubkeys
EACH_SAMPLE = 256       # good triples whose verdicts are held against native


def each_triples(sets, n: int, seed: str) -> tuple:
    """n triples of the peers' sets (repeated past the 2,500 of one round)
    with four bad ones at seeded positions: another share's partial, a
    cleared flag byte, the partial plus an order-13 point, an infinity
    signature; at EACH_BAD_PK two more, an infinity pubkey and one with its
    flag byte cleared, so that the pk cache rejects the set and the call
    decodes the pubkeys lane by lane. Returns ((pks, msgs, sigs), the bad
    positions, the same triples with only the first bad one, which
    verify_batch pairs through)."""
    flat = [t for _ in range(-(-n // (BULK_PEERS * BULK_VALIDATORS)))
            for i in sorted(sets) for t in zip(*sets[i])][:n]
    pks, msgs, sigs = (list(c) for c in zip(*flat))
    rng = random.Random(seed)
    bad = rng.sample(range(n), 6 if n == EACH_BAD_PK else 4)
    k = bad[0]
    other = next(j for j in range(n) if msgs[j] == msgs[k] and pks[j] != pks[k])
    tampered = list(sigs)
    tampered[k] = sigs[other]
    sigs = list(tampered)
    sigs[bad[1]] = bytes([sigs[bad[1]][0] & 0x7F]) + sigs[bad[1]][1:]
    sigs[bad[2]] = off_subgroup_g2(sigs[bad[2]])[1]
    sigs[bad[3]] = INF96
    tampered_pks = list(pks)
    if len(bad) == 6:
        pks[bad[4]] = INF48
        pks[bad[5]] = bytes([pks[bad[5]][0] & 0x7F]) + pks[bad[5]][1:]
    return (pks, msgs, sigs), sorted(bad), (tampered_pks, msgs, tampered)


def each_phase(sets, smi: str) -> dict:
    """The per-triple verify of phase 6 (TorchImpl().verify_batch_each, the
    coalescer's attribution after a failed flush) at EACH_SIZES, each call
    with four bad triples, six at EACH_BAD_PK (each_triples). The main
    path, every count at 0 just before: one call a size on a fresh
    TorchImpl (pk planes decoded, lane by lane at EACH_BAD_PK, H(m) hashed
    on the device); gates: the verdicts native ct_verify's on
    every bad triple and on EACH_SAMPLE seeded good ones, True on every
    good one. Then per size the steady wall and launches of
    verify_batch_each beside verify_batch's on the same triples with only
    the first bad one (the RLC check pairs through to False), medians of 3.
    Returns the main path's counts (path_counts)."""
    cases = {n: each_triples(sets, n, f"each {n}") for n in EACH_SIZES}
    impl = TorchImpl()
    CP.reset_counts()
    got = {n: impl.verify_batch_each(*trip) for n, (trip, _bad, _t) in cases.items()}
    torch.cuda.synchronize()
    counts = path_counts()
    for n, (trip, bad, _t) in cases.items():
        sample = sorted(random.Random(f"sample {n}").sample(
            [i for i in range(n) if i not in bad], EACH_SAMPLE))
        want = {i: native.verify(trip[0][i], trip[1][i], trip[2][i]) for i in bad + sample}
        if any(want[i] for i in bad) or not all(want[i] for i in sample):
            raise SystemExit(f"per-triple verify {n}: native ct_verify gives {want}")
        wrong = [i for i in want if bool(got[n][i]) != want[i]]
        if wrong or int(got[n].sum()) != n - len(bad):
            raise SystemExit(f"per-triple verify {n:,} triples: verdicts differ from native "
                             f"ct_verify at {wrong[:8]}; {int(got[n].sum())} True of {n - len(bad)} "
                             f"good")
        log(f"per-triple verify {n:,} triples: the {len(bad)} bad triples (signatures: another "
            f"share's partial, a cleared flag byte, an order-13 component, infinity"
            + ("; pubkeys, decoded lane by lane: infinity, a cleared flag byte" if len(bad) > 4
               else "") + f") False and {EACH_SAMPLE} sampled good ones True, as native "
            f"ct_verify; all {n - len(bad):,} good ones True")
    out = {}
    for n, (trip, _bad, tampered) in cases.items():
        row = {}
        for name, fn, args in (("verify_batch", impl.verify_batch, tampered),
                               ("verify_batch_each", impl.verify_batch_each, trip)):
            walls, launches = [], []
            for _ in range(3):
                CP.reset_counts()
                t0 = time.perf_counter()
                res = fn(*args)
                walls.append(time.perf_counter() - t0)
                launches.append(sum(sum(k.launches.values()) for k in CP.KERNELS.values()))
            if name == "verify_batch" and res is not False:
                raise SystemExit(f"verify_batch {n}: True on a tampered partial")
            row[name] = {"median_s": statistics.median(walls), "runs_s": walls,
                         "launches": launches[-1]}
        out[n] = row
        log(f"per-triple verify {n:,} triples (steady; {smi}): verify_batch_each median "
            f"{row['verify_batch_each']['median_s']:.4f} s, runs "
            + ", ".join(f"{w:.4f}" for w in row["verify_batch_each"]["runs_s"])
            + f", {row['verify_batch_each']['launches']} launches; beside verify_batch (one "
            f"tampered partial, False) median {row['verify_batch']['median_s']:.4f} s, "
            f"{row['verify_batch']['launches']} launches")
    log(f"per-triple verify JSON: {json.dumps(out)}")
    return counts


def bulk_verify(pool, smi: str) -> dict:
    """Phase 6: BASELINE config 3 at full size. The main path, every count
    at 0 just before: a fresh TorchImpl().verify_batch (device rung) on one
    peer's set and on the burst of five (pk planes decoded, H(m) hashed on
    the device); then the gates, the launches by chunk, and per size and
    rung the median of 3 steady verify_batch walls beside native
    ct_verify_batch's on the same triples. Returns what the counters held
    after the main path (path_counts)."""
    t0 = time.perf_counter()
    sets = bulk_sets(pool)
    log(f"bulk verify probe: {BULK_VALIDATORS} validators x {THRESHOLD}-of-{NUM_SHARES} "
        f"({BULK_ATTESTERS} attestation, {BULK_VALIDATORS - BULK_ATTESTERS} sync-committee roots), "
        f"{BULK_PEERS} peers' sets signed natively in {time.perf_counter() - t0:.1f} s")
    one = sets[1]
    burst = tuple(sum((list(sets[i][c]) for i in sets), []) for c in range(3))
    impl = TorchImpl()
    CP.reset_counts()
    oks = [impl.verify_batch(*one), impl.verify_batch(*burst)]
    counts = path_counts()
    launched = {(k, E): CP.KERNELS[k].launches[E] for k in CP.KERNELS for E in CP.KERNELS[k].variants}
    if oks != [True, True]:
        raise SystemExit(f"bulk verify main path: verdicts {oks} on valid triples")
    missing = [f"{k}<{E}>" for (k, E), c in launched.items() if c == 0 and (k, E) not in OFF_PATH]
    off = [f"{k}<{E}>={launched[k, E]}" for k, E in OFF_PATH if launched[k, E]]
    if missing or off:
        raise SystemExit(f"bulk verify main path launched no {missing}, and {off}")
    log(f"bulk verify main path ({len(one[0]):,}, then {len(burst[0]):,} triples, first: pk "
        "planes decoded, H(m) hashed on the device): launches "
        + ", ".join(f"{k}<{E}>={c}" for (k, E), c in launched.items()))
    bulk_gates(sets, impl.device)
    each_counts = each_phase(sets, smi)
    for triples in (one, burst):
        bulk_steps(triples, impl.device, f"{len(triples[0]):,} triples")
    for triples in (one, burst):
        label = f"{len(triples[0]):,}"
        # native ct_verify_batch, timed once for both rungs' lines
        nat = []
        for r in range(3):
            coefs = _coefs(len(triples[0]), f"{label} {r}")
            t0 = time.perf_counter()
            if not native.verify_batch(*triples, coefs):
                raise SystemExit(f"bulk verify {label}: native ct_verify_batch False")
            nat.append(time.perf_counter() - t0)
        for rung in PA.VERIFY_PATHS:
            rimpl = TorchImpl(verify=rung)
            rimpl.verify_batch(*triples)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                if not rimpl.verify_batch(*triples):
                    raise SystemExit(f"bulk verify {label} ({rung}): False on valid triples")
                walls.append(time.perf_counter() - t0)
            log(f"bulk verify {label} triples (verify={rung}, steady): median "
                f"{statistics.median(walls):.4f} s, runs " + ", ".join(f"{w:.4f}" for w in walls)
                + f"; native ct_verify_batch median {statistics.median(nat):.4f} s, runs "
                + ", ".join(f"{w:.4f}" for w in nat) + f" ({smi})")
    return merge_counts(counts, each_counts)


# ---------------------------------------------------------------------------
# The pipeline (phase 7): slots through threshold_aggregate_verify_submit
# ---------------------------------------------------------------------------

PIPE_MSGS = [bytes([0x70 + k]) * 32 for k in range(4)]


PIPE_ROUNDS = 3


def pipeline_phase(pool, jobs, pubkeys, smi: str) -> None:
    """Phase 7: four 1000 x 4-of-6 slots of the probe's keys, each over its
    own message, submitted back to back through the submit front door (the
    device's slot thread): every future's aggregates byte-identical to the
    serial threshold_aggregate_verify_batch's, every verdict True, and the
    submitted slots' launches exactly 4 times a steady serial slot's (the
    counters hold a lock: the slot thread counts beside this one); a slot
    with one tampered partial between two others gives False and leaves
    theirs untouched; the overlapped call gives the same bytes. Then
    PIPE_ROUNDS rounds of the four slots serial and submitted, in turns:
    the submitted median may exceed the serial median by no more than the
    spread of either set (max - min), the front door of core/sigagg being
    the submitted one."""
    slots = [sign_cluster(pool, jobs, [m] * N_VALIDATORS) for m in PIPE_MSGS]
    datas = [[m] * N_VALIDATORS for m in PIPE_MSGS]
    impl = TorchImpl()
    want = [impl.threshold_aggregate_verify_batch(b, pubkeys, d) for b, d in zip(slots, datas)]
    if not all(ok for _a, ok in want):
        raise SystemExit("pipeline phase: a serial slot verified False")
    CP.reset_counts()
    impl.threshold_aggregate_verify_batch(slots[0], pubkeys, datas[0])
    per_slot = sum(sum(k.launches.values()) for k in CP.KERNELS.values())

    def serial():
        """The four slots one after another: (wall s, results)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [impl.threshold_aggregate_verify_batch(b, pubkeys, d)
               for b, d in zip(slots, datas)]
        return time.perf_counter() - t0, got

    returned = []

    def submitted():
        """The four slots submitted back to back: (wall s, results); the
        seconds the four calls took to return go to `returned`."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [impl.threshold_aggregate_verify_submit(b, pubkeys, d)
                for b, d in zip(slots, datas)]
        returned.append(time.perf_counter() - t0)
        got = [f.result() for f in futs]
        return time.perf_counter() - t0, got

    CP.reset_counts()
    _s, got = submitted()
    launches = sum(sum(k.launches.values()) for k in CP.KERNELS.values())
    for k, ((aggs, ok), (w_aggs, _w)) in enumerate(zip(got, want)):
        if ok is not True or [bytes(a) for a in aggs] != [bytes(a) for a in w_aggs]:
            raise SystemExit(f"pipeline slot {k}: verdict {ok}, aggregates "
                             f"{sum(bytes(a) == bytes(w) for a, w in zip(aggs, w_aggs))}/"
                             f"{N_VALIDATORS} byte-identical to the serial call's")
    if launches != 4 * per_slot:
        raise SystemExit(f"pipeline: 4 submitted slots launched {launches}, a serial slot "
                         f"{per_slot}")
    log(f"pipeline: 4 slots submitted to the slot thread, each over its own message: 4/4 "
        f"futures byte-identical to the serial call and True; {launches} launches = 4 x "
        f"{per_slot} of a steady serial slot")
    v17, v18 = 17 % len(jobs), 18 % len(jobs)
    tampered = [dict(b) for b in slots[2]]
    first = sorted(tampered[v17])[0]
    tampered[v17][first] = slots[2][v18][sorted(slots[2][v18])[0]]
    futs = [impl.threshold_aggregate_verify_submit(b, pubkeys, d)
            for b, d in ((slots[0], datas[0]), (tampered, datas[2]), (slots[1], datas[1]))]
    (a0, ok0), (_at, ok_t), (a1, ok1) = [f.result() for f in futs]
    if ok_t or not (ok0 and ok1) or a0 != want[0][0] or a1 != want[1][0]:
        raise SystemExit(f"pipeline tampered slot: verdicts {ok0}, {ok_t}, {ok1}")
    log("pipeline: a slot with one tampered partial between two others gives False; theirs "
        "True and byte-identical")
    aggs, ok = impl.threshold_aggregate_verify_overlapped(slots[3], pubkeys, datas[3])
    if not ok or aggs != want[3][0]:
        raise SystemExit("pipeline: the overlapped call differs from the serial one")
    log("pipeline: threshold_aggregate_verify_overlapped gives the serial call's bytes, True")
    walls = {"serial": [], "submitted": []}
    for r in range(PIPE_ROUNDS):
        for name, run in (("serial", serial), ("submitted", submitted))[::1 - 2 * (r % 2)]:
            wall, got = run()
            if any(not ok or aggs != w for (aggs, ok), (w, _w) in zip(got, want)):
                raise SystemExit(f"pipeline walls: a {name} slot differs from the first "
                                 f"serial call")
            walls[name].append(wall)
    med = {name: statistics.median(w) for name, w in walls.items()}
    spread = max(max(w) - min(w) for w in walls.values())
    log(f"pipeline walls, 4 slots ({PIPE_ROUNDS} rounds in turns, s): submitted median "
        f"{med['submitted']:.4f}, runs {', '.join(f'{w:.4f}' for w in walls['submitted'])}; "
        f"serial median {med['serial']:.4f}, runs "
        f"{', '.join(f'{w:.4f}' for w in walls['serial'])}; spread {spread:.4f}; the four "
        f"submit calls returned in at most {max(returned) * 1e3:.2f} ms (steady: pk "
        f"plane and H(m) cached; device verify; interpreter switch interval "
        f"{sys.getswitchinterval() * 1e3:.1f} ms; {smi})")
    if med["submitted"] > med["serial"] + spread:
        raise SystemExit(f"pipeline: 4 submitted slots {med['submitted']:.4f} s exceed 4 serial "
                         f"{med['serial']:.4f} s by more than the spread {spread:.4f} s")


# ---------------------------------------------------------------------------
# DKG (phase 8): the FROST ceremony of BASELINE config 4
# ---------------------------------------------------------------------------

DKG_NODES, DKG_VALIDATORS, DKG_THRESHOLD = 6, 200, 4      # charon's ceil(2n/3) of 6
# the launches of one device keygen call (a pt_mul_windowed<1> sweep, the
# affine form's p-2 scan and its 4 product levels) and of one chunk of the
# grouped share-check MSM (G1 decompression 6, subgroup check 6, the sweep,
# the group reduction): the exact plain calls of tests/test_torch_frost.py
# and tests/test_torch_g1_msm.py on the CPU
DKG_KEYGEN_LAUNCHES = {"fe_pow": {"plane": 1}, "fe_mul": {1: 4}, "pt_mul_windowed": {1: 1}}
DKG_CHUNK_LAUNCHES = {"fe_mul": {1: 7}, "fe_addsub": {1: 3}, "fe_pow": {"plane": 1},
                      "pt_mul_shared": {1: 1}, "pt_mul_windowed": {1: 1},
                      "pt_reduce_groups": {1: 1}}
# the kernels the ceremony's device paths launch (E = 1 only)
DKG_PATH = (("fe_mul", 1), ("fe_addsub", 1), ("fe_pow", "plane"), ("pt_mul_shared", 1),
            ("pt_mul_windowed", 1), ("pt_reduce_groups", 1))


def _launches_by_kernel() -> dict:
    return {k: {v: c for v, c in kern.launches.items() if c}
            for k, kern in CP.KERNELS.items() if sum(kern.launches.values())}


def dkg_setup():
    """Seeded round-1 state of every node: per node (1-6) its 200
    participants (one a validator, context the validator's) with their
    coefficients set, and its PoK nonces."""
    rng = random.Random(411)
    parts, nonces = {}, {}
    for node in range(1, DKG_NODES + 1):
        parts[node] = [TF.Participant(node, DKG_THRESHOLD, DKG_NODES, b"chip-smoke dkg %d" % v,
                                      [rng.randrange(1, PF.R) for _ in range(DKG_THRESHOLD)])
                       for v in range(DKG_VALIDATORS)]
        nonces[node] = [rng.randrange(1, PF.R) for _ in range(DKG_VALIDATORS)]
    return parts, nonces


def dkg_items(node: int, bcasts, shares) -> list:
    """Node `node`'s share checks: (its index, dealer i's share to it, dealer
    i's commitments) for every validator and dealer."""
    return [(node, shares[i][v][node], bcasts[i][v].commitments)
            for v in range(DKG_VALIDATORS) for i in range(1, DKG_NODES + 1)]


def _raises(fn, exc_type, text: str | None = None) -> str:
    try:
        fn()
    except exc_type as exc:
        if text is not None and str(exc) != text:
            raise SystemExit(f"dkg: {exc_type.__name__}({str(exc)!r}), expected {text!r}")
        return str(exc)
    raise SystemExit(f"dkg: no {exc_type.__name__} ({text})")


def dkg_soundness(items, device) -> None:
    """A tampered share, an order-3 commitment and an infinity commitment in
    node 1's batch (at item 3): the device path's ValueError where a point
    is bad, then the per-item check's CharonError on the tampered item
    (the three before it pass natively, so the error is that item's)."""
    k = 3
    _node, share, cm = items[k]
    o3 = order3_g1()
    evil = PC.jac_add(PC.FqOps, g1_from_bytes(cm[0]), o3)
    if native.g1_check(g1_to_bytes(evil)):
        raise SystemExit("dkg: native ct_g1_check accepts a commitment with an order-3 component")
    cases = {"tampered share": ((share + 1) % PF.R, cm, None),
             "order-3 commitment": (share, [g1_to_bytes(evil)] + cm[1:], "G1 point not in subgroup"),
             "infinity commitment": (share, [INF48] + cm[1:], "infinity G1 point rejected")}
    for label, (sh, commitments, device_text) in cases.items():
        bad = items[:k] + [(items[k][0], sh, commitments)] + items[k + 1:]
        if device_text is None:
            if TF._verify_shares_device(bad, device):
                raise SystemExit(f"dkg {label}: the device equation holds")
            what = "device equation False"
        else:
            _raises(lambda: TF._verify_shares_device(bad, device), ValueError, device_text)
            what = f"device ValueError({device_text!r})"
        before = TF.MSM_PATHS["native"]
        err = _raises(lambda: TF.verify_shares_batch(bad, device), errors.CharonError,
                      "share does not match commitments: index=1")
        if TF.MSM_PATHS["native"] - before != k:
            raise SystemExit(f"dkg {label}: {TF.MSM_PATHS['native'] - before} items passed "
                             f"natively before the error, not {k}")
        log(f"dkg soundness, {label} (dealer {k % DKG_NODES + 1}, validator {k // DKG_NODES}): "
            f"{what}; verify_shares_batch raises CharonError({err!r}) at that item")
    _raises(lambda: TF.verify_round1(TF.Round1Broadcast(1, [INF48] + cm[1:], INF48, 0),
                                     DKG_THRESHOLD, b""), errors.CharonError,
            "infinity or malformed commitment: degree=0 participant=1")
    log("dkg soundness: verify_round1 rejects the infinity commitment")


def dkg_mixed(items1, items2, device) -> None:
    """Two evaluation points (nodes 1 and 2, 128 validators each: 1,024
    commitment points) through g1_lincomb_is_infinity: True, and False with
    a tampered share, each the native per-item verdict."""
    mixed = items1[:128] + items2[:128]
    tampered = list(mixed)
    k = len(items1[:128]) + 2
    mi, sh, cm = tampered[k]
    tampered[k] = (mi, (sh + 1) % PF.R, cm)

    def native_verdict(batch) -> bool:
        try:
            for it in batch:
                TF.verify_share(*it)
        except errors.CharonError:
            return False
        return True

    pts = sum(len(c) for _, _, c in mixed)
    for label, batch, want in (("valid", mixed, True), ("tampered", tampered, False)):
        got = TF._verify_shares_device(batch, device)
        if got is not want or native_verdict(batch) is not want:
            raise SystemExit(f"dkg mixed points ({label}): device {got}, native per-item "
                             f"{native_verdict(batch)}, expected {want}")
        log(f"dkg mixed evaluation points ({len(batch)} checks, {pts} points, "
            f"g1_lincomb_is_infinity): {label} {got}, as native per-item verify_share")


def dkg_pinned(items, device) -> None:
    """One keygen call and one chunk of the grouped MSM launch exactly what
    they do on the CPU."""
    CP.reset_counts()
    PA.g1_mul_gen_batch([p for p in range(1, 1001)], device)
    torch.cuda.synchronize()
    keygen = _launches_by_kernel()
    pts = [c for _, _, cm in items for c in cm]
    CP.reset_counts()
    ok, sub_ok, _sums = PA.groups_msm_chunk(pts, [1] * len(pts),
                                            [k % DKG_THRESHOLD for k in range(len(pts))],
                                            DKG_THRESHOLD, 0, min(CP.TILE, len(pts)), device)
    torch.cuda.synchronize()
    chunk = _launches_by_kernel()
    if keygen != DKG_KEYGEN_LAUNCHES or chunk != DKG_CHUNK_LAUNCHES or not (bool(ok) and bool(sub_ok)):
        raise SystemExit(f"dkg launches: keygen {keygen}, a chunk {chunk}; the CPU's "
                         f"{DKG_KEYGEN_LAUNCHES}, {DKG_CHUNK_LAUNCHES}")
    log(f"dkg launches: a keygen call {sum(sum(v.values()) for v in keygen.values())}, a chunk "
        f"{sum(sum(v.values()) for v in chunk.values())}, by kernel as on the CPU")


def dkg_walls(parts, nonces, items, device, smi: str) -> None:
    """Medians of 3 walls: the device keygen of one node's 1,000 scalars
    against serial native ct_pubkey, and one node's 1,200 share checks
    through verify_shares_batch against native per-item verify_share."""
    scalars = [a for p in parts[1] for a in p._coeffs] + nonces[1]

    def walls(fn) -> list:
        out = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    def per_item():
        for it in items:
            TF.verify_share(*it)

    PA.g1_mul_gen_batch(scalars, device)
    runs = {"device keygen": walls(lambda: PA.g1_mul_gen_batch(scalars, device)),
            "native keygen": walls(lambda: [_pubkey(s) for s in scalars]),
            "device share check": walls(lambda: TF.verify_shares_batch(items, device)),
            "native per-item share check": walls(per_item)}
    for label, ws in runs.items():
        log(f"dkg wall, {label} ({len(scalars) if 'keygen' in label else len(items):,} "
            f"{'scalars' if 'keygen' in label else 'checks'}): median "
            f"{statistics.median(ws):.4f} s, runs " + ", ".join(f"{w:.4f}" for w in ws)
            + f" ({smi})")


def dkg_phase(pool, smi: str, device) -> tuple[dict, dict, dict]:
    """Phase 8: BASELINE config 4 at full size, six nodes of one process.
    The main path, counts at 0 just before and read just after: round 1 of
    every node through round1_batch with device keygen (1,000 generator
    multiplications a node, one 1,024-lane launch), then every node's 1,200
    share checks through verify_shares_batch (4,800 points in chunks of
    1,024 x 4 and 704, all on the device path). Then: the 6,000 points
    byte-identical to native ct_pubkey; verify_round1 of every broadcast by
    every node; finalize of all 200 validators on every node, the six
    agreeing on the group pubkeys and each share pubkey native ct_pubkey of
    its share; the soundness and mixed-point cases; one keygen call's and
    one chunk's launches against the CPU's; the walls. Returns (the main
    path's launches by (kernel, variant), what the counters held after it,
    and what they held over it and the soundness and mixed-point cases)."""
    t0 = time.perf_counter()
    parts, nonces = dkg_setup()
    prev_keygen = TF.DEVICE_KEYGEN
    TF.enable_device_keygen()
    msm_before = dict(TF.MSM_PATHS)
    CP.reset_counts()
    rounds = {node: TF.round1_batch(parts[node], nonces[node], device) for node in parts}
    bcasts = {i: [b for b, _s in rounds[i]] for i in rounds}
    shares = {i: [s for _b, s in rounds[i]] for i in rounds}
    items = {j: dkg_items(j, bcasts, shares) for j in rounds}
    for j in items:
        TF.verify_shares_batch(items[j], device)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {(k, E): CP.KERNELS[k].launches[E] for k in CP.KERNELS for E in CP.KERNELS[k].variants}
    main = path_counts()
    TF.DEVICE_KEYGEN = prev_keygen
    device_checks = TF.MSM_PATHS["device"] - msm_before.get("device", 0)
    native_checks = TF.MSM_PATHS["native"] - msm_before.get("native", 0)
    missing = [f"{k}<{E}>" for k, E in DKG_PATH if launches[k, E] == 0]
    off = [f"{k}<{E}>={c}" for (k, E), c in launches.items() if c and (k, E) not in DKG_PATH]
    # 6 keygen calls and 6 x 5 chunks (4,800 points: 1,024 x 4 and 704)
    chunks = -(-len(items[1]) * DKG_THRESHOLD // CP.TILE)
    want = {name: {v: DKG_NODES * DKG_KEYGEN_LAUNCHES.get(name, {}).get(v, 0)
                   + DKG_NODES * chunks * DKG_CHUNK_LAUNCHES.get(name, {}).get(v, 0)
                   for v in {**DKG_KEYGEN_LAUNCHES.get(name, {}), **DKG_CHUNK_LAUNCHES.get(name, {})}}
            for name in {**DKG_KEYGEN_LAUNCHES, **DKG_CHUNK_LAUNCHES}}
    got = _launches_by_kernel()
    if missing or off or got != want:
        raise SystemExit(f"dkg main path launched no {missing}, and {off}; launches {got}, "
                         f"expected {DKG_NODES} keygen calls and {DKG_NODES * chunks} chunks: "
                         f"{want}")
    if device_checks != DKG_NODES * len(items[1]) or native_checks:
        raise SystemExit(f"dkg: {device_checks} share checks took the device path and "
                         f"{native_checks} the native one")
    log(f"dkg main path ({DKG_NODES} nodes x {DKG_VALIDATORS} validators, threshold "
        f"{DKG_THRESHOLD}; round 1 with device keygen, then every node's "
        f"{len(items[1]):,} share checks): {main_s:.3f} s; all {device_checks:,} checks on the "
        "device path; launches " + ", ".join(f"{k}<{E}>={launches[k, E]}" for k, E in DKG_PATH))

    flat = [(node, v, k, parts[node][v]._coeffs[k]) for node in parts
            for v in range(DKG_VALIDATORS) for k in range(DKG_THRESHOLD)]
    flat += [(node, v, "pok", nonces[node][v]) for node in parts for v in range(DKG_VALIDATORS)]
    oracle = list(pool.map(lambda t: _pubkey(t[3]), flat))
    for (node, v, k, _s), want_b in zip(flat, oracle):
        b = bcasts[node][v]
        got_b = b.pok_r if k == "pok" else b.commitments[k]
        if got_b != want_b:
            raise SystemExit(f"dkg keygen: node {node} validator {v} point {k} differs from "
                             "native ct_pubkey")
    log(f"dkg round 1: all {len(flat):,} commitments and PoK points byte-identical to native "
        "ct_pubkey")
    jobs = [(b, v) for i in bcasts for v, b in enumerate(bcasts[i])]
    for _ in range(DKG_NODES):
        list(pool.map(lambda t: TF.verify_round1(t[0], DKG_THRESHOLD, parts[1][t[1]].context), jobs))
    log(f"dkg round 2: verify_round1 of all {len(jobs):,} broadcasts on each of the "
        f"{DKG_NODES} nodes")
    results = {}
    for j in rounds:
        results[j] = list(pool.map(
            lambda v, j=j: TF.finalize(j, DKG_NODES, {i: bcasts[i][v] for i in bcasts},
                                       {i: shares[i][v][j] for i in shares}),
            range(DKG_VALIDATORS)))
    for v in range(DKG_VALIDATORS):
        if len({bytes(results[j][v].group_pubkey) for j in results}) != 1:
            raise SystemExit(f"dkg finalize: the nodes disagree on validator {v}'s group pubkey")
        for j in results:
            if {i: bytes(pk) for i, pk in results[j][v].share_pubkeys.items()} != \
                    {i: bytes(pk) for i, pk in results[1][v].share_pubkeys.items()}:
                raise SystemExit(f"dkg finalize: node {j} derives other share pubkeys")
    share_pks = [(bytes(results[j][v].share_pubkeys[j]), results[j][v].share_secret)
                 for j in results for v in range(DKG_VALIDATORS)]
    if any(pk != native.pubkey(sk) for pk, sk in share_pks):
        raise SystemExit("dkg finalize: a share pubkey is not native ct_pubkey of its share")
    log(f"dkg finalize: the {DKG_NODES} nodes agree on all {DKG_VALIDATORS} group pubkeys and "
        f"share pubkeys; all {len(share_pks):,} own share pubkeys are native ct_pubkey of their "
        "shares")

    CP.reset_counts()
    dkg_soundness(items[1], device)
    dkg_mixed(items[1], items[2], device)
    extra = path_counts()
    dkg_pinned(items[1], device)
    dkg_walls(parts, nonces, items[1], device, smi)
    return launches, main, merge_counts(main, extra), items[1]


# ---------------------------------------------------------------------------
# The guard (phase 9): the fault seam, the plane breaker, the native slot
# rung, the verify fallback, the watchdog and the ceremony's fallback
# ---------------------------------------------------------------------------

GUARD_SITES = ("sigagg.pack", "sigagg.execute", "sigagg.readback", "sigagg.finish")
GUARD_DEADLINE_S = 2.0      # the watchdog's deadline in phase 9
# the breaker's cooldown in phase 9: longer than the third failure's native
# landing (1.3-1.6 s at 1000 validators on the H100 host), which runs after
# the breaker opened, so that the next slot still finds it open
GUARD_COOLDOWN_S = 5.0


def guard_quiet(label: str) -> None:
    """Fail the run unless no device failure was absorbed: every guard
    counter at 0, the breaker closed, no ceremony fallback."""
    c = GD.counters()
    if c["fallback"] or c["watchdog"] or c["breaker"] != GD.CLOSED or TF.FALLBACKS:
        raise SystemExit(f"{label}: a device failure was absorbed: guard {c}, ceremony "
                         f"{dict(TF.FALLBACKS)}")
    log(f"{label}: every guard counter at 0, the breaker closed, no ceremony fallback")


def _guarded() -> TorchImpl:
    impl = TorchImpl()
    impl.fallback_on_device_error = True
    return impl


def _launch_total() -> int:
    return sum(sum(k.launches.values()) for k in CP.KERNELS.values())


def _timed_slot(impl: TorchImpl, args, submit: bool = False) -> tuple:
    """((aggregate bytes, ok), synchronised wall seconds) of one slot."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if submit:
        aggs, ok = impl.threshold_aggregate_verify_submit(*args).result(timeout=120)
    else:
        aggs, ok = impl.threshold_aggregate_verify_batch(*args)
    torch.cuda.synchronize()
    return ([bytes(a) for a in aggs], ok), time.perf_counter() - t0


def _landed_once(label: str, reason: str, before: int) -> None:
    if GD.fallback_total(reason) != before + 1:
        raise SystemExit(f"guard {label}: FALLBACKS[({reason!r}, 'native')] went "
                         f"{before} -> {GD.fallback_total(reason)}, not up by one")


def guard_phase(pool, batches, pubkeys, tampered, phase4_launches: dict, dkg_items,
                smi: str, device) -> dict:
    """Phase 9: the guard at the headline's full width (1000 x 4-of-6, the
    probe's keys and message), on TorchImpls with fallback_on_device_error
    on. (1) A fault-free device slot gives the reference bytes and verdict,
    equal to native ct_lincomb_g2 of every validator; three steady device
    slots timed. (2) One slot a site (sigagg.pack, .execute, .readback,
    .finish) with a planned device_lost fault and one with a timeout fault:
    each lands on the native rung with the reference bytes and verdict,
    FALLBACKS[(reason, "native")] up by one. (3) A tampered partial under a
    fault: False. (4) A bad encoding: the reference's ValueError text, no
    landing counted. (5) The breaker (threshold 3, cooldown GUARD_COOLDOWN_S): three
    sigagg.pack failures open it; the next slot launches no kernel and
    lands as breaker_open; after the cooldown a fault-free probe slot on a
    fresh TorchImpl launches phase 4's first slot's kernels and closes the
    breaker. (6) The verify fallback: device_pairing_check raising
    DeviceLostFault gives the native verdict, pairing_path["native"] up by
    the slot's pairs. (7) The watchdog (deadline 2 s): a submitted slot
    whose readback is held resolves from the native rung, byte-identical,
    watchdog_total 1; the next submitted slot runs on a fresh slot thread
    on the device, with a steady slot's launches. (8) Node 1's 1,200 share
    checks of phase 8 with frost.msm device_lost: no error, all counted
    native, one ceremony fallback; a tampered share under the fault gives
    phase 8's CharonError; with the breaker open device_gate is False.
    Returns the phase's JSON (counters, walls, the card)."""
    t_phase = time.perf_counter()
    datas = [MSG] * N_VALIDATORS
    args = (batches, pubkeys, datas)
    deadline_env = os.environ.get(GD.SLOT_DEADLINE_ENV)
    GD.reset_for_testing()
    GD.configure(threshold=10 ** 6, cooldown=30.0)   # (1)-(4): no landing opens the breaker
    impl = _guarded()
    ref, first_s = _timed_slot(impl, args)

    def oracle(batch):
        ids = sorted(batch)
        return _lincomb([batch[i] for i in ids], PF.lagrange_coefficients_at_zero(ids))

    if ref[1] is not True or ref[0] != list(pool.map(oracle, batches)):
        raise SystemExit("guard: the fault-free device slot is not native ct_lincomb_g2's / True")
    device_s = []
    for _ in range(3):
        CP.reset_counts()
        got, wall = _timed_slot(impl, args)
        steady_launches = _launch_total()
        device_s.append(wall)
        if got != ref:
            raise SystemExit("guard: a steady device slot differs from the first")
    log(f"guard reference slot: {N_VALIDATORS}/{N_VALIDATORS} aggregates native ct_lincomb_g2's, "
        f"True; first {first_s:.4f} s, steady median {statistics.median(device_s):.4f} s "
        f"({steady_launches} launches a steady slot)")

    native_s, landed = [], {}
    try:
        for site, kind in [(s, "device_lost") for s in GUARD_SITES] + [("sigagg.execute",
                                                                          "timeout")]:
            before = GD.fallback_total(kind)
            faults.arm([{"site": site, "kind": kind}])
            got, wall = _timed_slot(impl, args)
            faults.disarm()
            if got != ref:
                raise SystemExit(f"guard {site} {kind}: the native landing gave "
                                 f"{sum(a == b for a, b in zip(got[0], ref[0]))}/{N_VALIDATORS} "
                                 f"reference aggregates, verdict {got[1]}")
            _landed_once(f"{site} {kind}", kind, before)
            if impl.last_times.native <= 0 or faults.injected(site) < 1:
                raise SystemExit(f"guard {site} {kind}: no native time or no fault fired")
            landed[f"{site} {kind}"] = wall
            if site == "sigagg.pack":
                native_s.append(wall)
            log(f"guard {site} {kind}: landed native in {wall:.4f} s (native rung "
                f"{impl.last_times.native:.4f} s), {N_VALIDATORS}/{N_VALIDATORS} aggregates the "
                f"reference's, {got[1]}")

        before = GD.fallback_total("device_lost")
        faults.arm([{"site": "sigagg.execute"}])
        (_aggs, ok_t), _wall = _timed_slot(impl, (tampered, pubkeys, datas))
        faults.disarm()
        if ok_t is not False:
            raise SystemExit("guard: a tampered partial under a fault verified True")
        _landed_once("tampered", "device_lost", before)
        log("guard: a tampered partial under a sigagg.execute fault lands native, False")

        bad = [dict(b) for b in batches]
        v300 = 300 % len(batches)
        i1 = sorted(bad[v300])[1]
        bad[v300][i1] = off_curve_x(bad[v300][i1])
        want_text = f"invalid G2 point at index {PA.layout_slots(bad)[0].index(bad[v300][i1])}"
        counts = GD.counters()
        try:
            impl.threshold_aggregate_verify_batch(bad, pubkeys, datas)
        except ValueError as exc:
            if str(exc) != want_text or GD.counters() != counts:
                raise SystemExit(f"guard bad encoding: {exc!r}, counters {GD.counters()}; "
                                 f"expected ValueError({want_text!r}) and {counts}")
        else:
            raise SystemExit("guard: a bad encoding did not raise")
        log(f"guard bad encoding: ValueError({want_text!r}), no landing counted")

        GD.configure(threshold=3, cooldown=GUARD_COOLDOWN_S)
        faults.arm([{"site": "sigagg.pack", "count": 3}])
        for k in range(3):
            got, wall = _timed_slot(impl, args)
            if got != ref or GD.BREAKER.state != (GD.OPEN if k == 2 else GD.CLOSED):
                raise SystemExit(f"guard breaker: failure {k + 1} gave state {GD.BREAKER.state}")
            native_s.append(wall)
        faults.disarm()
        opened = time.perf_counter()       # the breaker opened before this
        CP.reset_counts()
        before = GD.fallback_total("breaker_open")
        got, wall = _timed_slot(impl, args)
        if got != ref or _launch_total() != 0:
            raise SystemExit(f"guard breaker open: {_launch_total()} launches, aggregates "
                             f"{'equal' if got == ref else 'different'}")
        _landed_once("breaker open", "breaker_open", before)
        native_s.append(wall)
        time.sleep(max(0.0, GUARD_COOLDOWN_S + 0.05 - (time.perf_counter() - opened)))
        probe_impl = _guarded()
        CP.reset_counts()
        got, probe_s = _timed_slot(probe_impl, args)
        probe = {(k, E): CP.KERNELS[k].launches[E] for k in CP.KERNELS
                 for E in CP.KERNELS[k].variants}
        if got != ref or probe != phase4_launches or GD.BREAKER.state != GD.CLOSED:
            raise SystemExit(f"guard probe: launches {probe} (phase 4: {phase4_launches}), "
                             f"breaker {GD.BREAKER.state}")
        log(f"guard breaker: 3 sigagg.pack failures opened it; the next slot launched 0 kernels "
            f"and landed as breaker_open in {wall:.4f} s; after the {GUARD_COOLDOWN_S} s cooldown "
            f"the probe slot "
            f"launched phase 4's {sum(probe.values())} kernels in {probe_s:.4f} s and closed it")

        GD.configure(threshold=3, cooldown=30.0)
        real_check = PA.device_pairing_check

        def lost(*_a):
            raise faults.DeviceLostFault("device pairing check lost (planned)")

        PA.device_pairing_check = lost
        try:
            before_fb, before_path = GD.fallback_total("device_lost"), dict(impl.pairing_path)
            got, wall = _timed_slot(impl, args)
            pairs = len(set(datas)) + 1
            grew = {r: impl.pairing_path.get(r, 0) - before_path.get(r, 0) for r in PA.VERIFY_PATHS}
            if got != ref or grew != {"device": 0, "native": pairs}:
                raise SystemExit(f"guard verify fallback: pairs by rung {grew}, verdict {got[1]}")
            _landed_once("verify fallback", "device_lost", before_fb)
            (_aggs, ok_t), _wall = _timed_slot(impl, (tampered, pubkeys, datas))
            if ok_t is not False:
                raise SystemExit("guard verify fallback: the tampered slot verified True")
        finally:
            PA.device_pairing_check = real_check
        log(f"guard verify fallback: the device pairing check lost, the native rung's verdict "
            f"True ({pairs} pairs native) in {wall:.4f} s; tampered False")

        GD.configure(threshold=3, cooldown=30.0, slot_deadline=GUARD_DEADLINE_S)
        gate, threads = threading.Event(), []
        real_readback = PA.readback
        hung_pool = TI.slot_thread(impl.device)

        def held(state):
            threads.append(threading.current_thread())
            if len(threads) == 1:
                gate.wait(120)
            return real_readback(state)

        PA.readback = held
        try:
            got, wd_s = _timed_slot(impl, args, submit=True)
            if got != ref or GD.watchdog_total() != 1 or GD.fallback_total("watchdog_timeout") != 1:
                raise SystemExit(f"guard watchdog: counters {GD.counters()}, aggregates "
                                 f"{'equal' if got == ref else 'different'}")
            CP.reset_counts()
            got, next_s = _timed_slot(impl, args, submit=True)
            fresh = len(threads) == 2 and threads[1] is not threads[0]
            if got != ref or not fresh or _launch_total() != steady_launches:
                raise SystemExit(f"guard watchdog: the next slot launched {_launch_total()} "
                                 f"(steady {steady_launches}); readbacks on {len(threads)} "
                                 f"threads, a fresh one: {fresh}; counters {GD.counters()}")
        finally:
            gate.set()
            PA.readback = real_readback
            hung_pool.shutdown(wait=True)
            if deadline_env is None:
                os.environ.pop(GD.SLOT_DEADLINE_ENV, None)
            else:
                os.environ[GD.SLOT_DEADLINE_ENV] = deadline_env
        log(f"guard watchdog (deadline {GUARD_DEADLINE_S} s): the held slot resolved from the "
            f"native rung in {wd_s:.4f} s, byte-identical; watchdog_total 1; the next submitted slot ran on a "
            f"fresh slot thread with a steady slot's {steady_launches} launches in {next_s:.4f} s")

        GD.configure(threshold=3, cooldown=30.0)
        before = (TF.MSM_PATHS["native"], TF.FALLBACKS["frost.msm", "device_lost"],
                  GD.fallback_total("device_lost"))
        faults.arm([{"site": "frost.msm"}])
        t0 = time.perf_counter()
        TF.verify_shares_batch(dkg_items, device)
        dkg_s = time.perf_counter() - t0
        after = (TF.MSM_PATHS["native"], TF.FALLBACKS["frost.msm", "device_lost"],
                 GD.fallback_total("device_lost"))
        if after != (before[0] + len(dkg_items), before[1] + 1, before[2] + 1):
            raise SystemExit(f"guard dkg: native checks, ceremony and guard fallbacks went "
                             f"{before} -> {after}")
        faults.arm([{"site": "frost.msm"}])
        mi, sh, cm = dkg_items[3]
        bad_items = dkg_items[:3] + [(mi, (sh + 1) % PF.R, cm)] + dkg_items[4:]
        _raises(lambda: TF.verify_shares_batch(bad_items, device),
                errors.CharonError, "share does not match commitments: index=1")
        faults.disarm()
        GD.configure(threshold=1, cooldown=60.0)
        GD.BREAKER.record_failure()
        if TF.device_gate(sum(len(c) for _, _, c in dkg_items)):
            raise SystemExit("guard dkg: device_gate admits a batch with the breaker open")
        log(f"guard dkg: node 1's {len(dkg_items):,} share checks under a frost.msm device_lost "
            f"fault pass natively in {dkg_s:.4f} s, as in phase 8; a tampered share raises phase "
            f"8's CharonError; with the breaker open device_gate is False")
    finally:
        faults.disarm()
    counters = GD.counters()
    out = {"counters": {"fallback": {f"{r}/{t}": n for (r, t), n in
                                     sorted(counters["fallback"].items())},
                        "watchdog": counters["watchdog"], "breaker_at_end": counters["breaker"],
                        "ceremony": {f"{p}/{r}": n for (p, r), n in sorted(TF.FALLBACKS.items())}},
           "device_slot_s": {"median": statistics.median(device_s), "runs": device_s},
           "native_landed_slot_s": {"median": statistics.median(native_s), "runs": native_s},
           "landed_by_fault_s": landed, "watchdog_slot_s": wd_s, "dkg_native_checks_s": dkg_s,
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    log(f"guard walls ({smi}): native-landed slot median "
        f"{out['native_landed_slot_s']['median']:.4f} s beside the device slot's {out['device_slot_s']['median']:.4f} s; phase 9 "
        f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The duty pipeline's signing back half (phase 10): node 1 of a 4-of-6
# cluster, ParSigEx -> ParSigDB -> SigAgg -> AggSigDB through the coalescer
# ---------------------------------------------------------------------------

# (label, validators, duty types of each slot): BASELINE configs 2 and 3 and
# the headline's width
DUTY_CONFIGS = (("config 2", 100, ("attester",)),
                ("config 3", 500, ("attester", "sync_message")),
                ("1000 x 4-of-6", 1000, ("attester",)))
DUTY_ROUNDS = 5         # slots a config, each fresh
DUTY_SLOT0 = 4096       # the current slot when a config starts
DUTY_TIMEOUT_S = 300.0
DUTY_SLOT_S = 12.0      # a tampered window must end within the slot
DUTY_TYPES = {"attester": "ATTESTER", "sync_message": "SYNC_MESSAGE"}     # DutyType names
ZERO96 = bytes(96)


def duty_modules() -> types.SimpleNamespace:
    """The port's back half, as DutyNode and duty_sets take a package."""
    return types.SimpleNamespace(aggsigdb=aggsigdb, aio=aio, coalesce=coalesce, deadline=deadline,
                                 gater=gater, parsigdb=parsigdb, parsigex=parsigex, sigagg=sigagg,
                                 signeddata=signeddata, spec=ES, types=CT)


class DutyNode:
    """One node's signing back half, wired as the reference's node wires it
    (charon_tpu/app/app.py:413-426): ParSigEx, whose batch verifier goes
    through the coalescer, into ParSigDB.store_external; ParSigDB's
    threshold into SigAgg (through the coalescer) and AggSigDB. `m` holds a
    package's modules (duty_modules()), so the tests run the reference's
    components through the same wiring. Records each inbound set's verify
    (its wall, and its error), each duty's threshold and store times, and
    every coalescer flush: (kind, submissions, items, start, end).
    `coalescer` goes to TblsCoalescer (its defaults: a 25 ms window, a
    flush at policy.flush_at_default(), a 12 s admission budget)."""

    def __init__(self, m, keys, chain, **coalescer):
        self.m, self.chain = m, chain
        deadliner = m.deadline.Deadliner(m.deadline.new_duty_deadline_func(chain))
        self.co = m.coalesce.TblsCoalescer(**coalescer)
        self.db = m.parsigdb.MemDB(keys.threshold, deadliner)
        self.agg = m.sigagg.SigAgg(keys, chain, coalescer=self.co)
        self.adb = m.aggsigdb.MemDB(deadliner)
        self.transport = m.parsigex.MemTransport()
        self.verify_set = self._timed_verify(
            m.parsigex.new_batch_eth2_verifier(chain, keys, coalescer=self.co))
        self.ex = m.parsigex.ParSigEx(self.transport, keys.my_share_idx,
                                      m.gater.new_duty_gater(chain), self.verify_set)
        self.ex.subscribe(self.db.store_external)
        self.db.subscribe_threshold(self._on_threshold)
        self.db.subscribe_threshold(self._aggregate)
        self.agg.subscribe(self.adb.store)
        self.agg.subscribe(self._on_stored)
        self.verifies, self.errors, self.flushes, self.failures = [], [], [], []
        self.threshold_at, self.stored_at = {}, {}
        self.on_flush = None        # called with the kind as a flush starts
        for w in (self.co._agg, self.co._ver):
            w._dispatch = self._timed_flush(w.kind, w._dispatch)

    def _timed_verify(self, verify):
        async def verify_set(duty, parsigs):
            sender = next(iter(parsigs.values())).share_idx
            t0 = time.perf_counter()
            try:
                await verify(duty, parsigs)
            except Exception as exc:
                self.errors.append((duty, sender, exc))
                raise
            finally:
                self.verifies.append((duty, sender, t0, time.perf_counter()))
        return verify_set

    def _timed_flush(self, kind: str, dispatch):
        async def run(payloads, futs):
            # [kind, submissions, items, start, end]; end None while it runs
            rec = [kind, len(payloads), sum(len(p[0]) for p in payloads), time.perf_counter(), None]
            self.flushes.append(rec)
            if self.on_flush is not None:
                self.on_flush(kind)
            try:
                await dispatch(payloads, futs)
            finally:
                rec[4] = time.perf_counter()
        return run

    async def _on_threshold(self, duty, payload) -> None:
        self.threshold_at.setdefault(duty, time.perf_counter())

    async def _aggregate(self, duty, payload) -> None:
        """SigAgg.aggregate, its error recorded (the inbound set's handler
        that reached the threshold only logs it)."""
        try:
            await self.agg.aggregate(duty, payload)
        except Exception as exc:
            self.failures.append((duty, exc))
            raise

    async def _on_stored(self, duty, signed) -> None:
        self.stored_at[duty] = time.perf_counter()

    async def deliver(self, duties) -> dict:
        """duties: [(duty, own set, {peer: set})]. The node's own partials go
        to ParSigDB, then every peer's sets arrive through the transport, all
        at once, peer by peer (a peer sends its sets of the slot's duties
        together); returns {(duty, pubkey): aggregate bytes} once every
        validator of every duty has its aggregate in AggSigDB and every
        inbound set was handled. The chain's clock is set first so that the
        first duty's slot is the current one, 6 s in: the gater passes the
        duties and the deadliner keeps them for five slots."""
        self.chain.genesis_time = time.time() - duties[0][0].slot * 12.0 - 6.0
        for duty, own, _peers in duties:
            await self.db.store_internal(duty, own)
        for peer in duties[0][2]:
            for duty, _own, peers in duties:
                await self.transport.broadcast(peer, duty, peers[peer])
        out = {}
        t_end = time.perf_counter() + DUTY_TIMEOUT_S
        for duty, own, _peers in duties:
            for pk in own:
                waiter = asyncio.ensure_future(self.adb.await_(duty, pk))
                while not waiter.done():
                    await asyncio.wait({waiter}, timeout=0.01)
                    if self.failures or time.perf_counter() > t_end:
                        waiter.cancel()
                        t0 = min(f[3] for f in self.flushes) if self.flushes else 0.0
                        raise RuntimeError(
                            f"duty {duty}: no aggregate of {pk[:10]} in AggSigDB: sigagg raised "
                            f"{self.failures[:1]}; flushes (kind, submissions, items, start, end) "
                            f"{[(k, c, i, round(a - t0, 4), b and round(b - t0, 4)) for k, c, i, a, b in self.flushes]}"
                            f"; verifies {[(str(d), x, round(a - t0, 4), round(b - t0, 4)) for d, x, a, b in self.verifies]}")
                out[duty, pk] = bytes(waiter.result().signature())
        # every inbound set handled (aio.spawn's tasks reaped)
        while self.m.aio.pending_count():
            await asyncio.sleep(0.001)
        return out

    def verify_wall(self, duty) -> float:
        runs = [(t0, t1) for d, _s, t0, t1 in self.verifies if d == duty]
        return max(t1 for _t0, t1 in runs) - min(t0 for t0, _t1 in runs)


def duty_cluster(pool, n: int, seed: int = 13) -> dict:
    """n validators at 4-of-6 from a seed: root and share secrets (ints),
    root and share pubkeys (bytes) by native ct_pubkey."""
    rng = random.Random(seed)
    roots = [rng.randrange(1, PF.R) for _ in range(n)]
    shares = [shamir_split(sk, NUM_SHARES, THRESHOLD, rng) for sk in roots]
    flat = [(v, i) for v in range(n) for i in range(NUM_SHARES + 1)]
    pks = list(pool.map(lambda t: _pubkey(shares[t[0]][t[1]] if t[1] else roots[t[0]]), flat))
    k = NUM_SHARES + 1
    return {"root_sk": roots, "share_sk": shares, "root_pk": pks[::k],
            "share_pk": [dict(zip(range(1, k), pks[v * k + 1:(v + 1) * k])) for v in range(n)]}


def duty_data(m, kind: str, slot: int, v: int):
    """Validator v's unsigned datum of a duty of `kind` at `slot`: an
    attestation of committee 0 (every validator of the slot signs the same
    data) or a sync-committee message over the slot's block root."""
    block = hashlib.sha256(b"block %d" % slot).digest()
    if kind == "attester":
        epoch = slot // 32
        data = m.spec.AttestationData(
            slot, 0, block, m.spec.Checkpoint(epoch - 1, hashlib.sha256(b"source").digest()),
            m.spec.Checkpoint(epoch, hashlib.sha256(b"target %d" % epoch).digest()))
        return m.signeddata.SignedAttestation(m.spec.Attestation([True], data, ZERO96))
    return m.signeddata.SignedSyncMessage(m.spec.SyncCommitteeMessage(slot, block, v, ZERO96))


def duty_sets(m, pool, cluster: dict, chain, kind: str, slot: int, n: int, node: int = 1,
              tamper: int | None = None) -> tuple:
    """(duty, node's own set, {peer: set}, signing root) of the first n
    validators: every share's partial over the duty's signing root, made
    natively (H(m) once, then each share's scalar multiple of it). With
    `tamper`, that peer's partial of validator 0 is over another root."""
    duty = m.types.Duty(slot, m.types.DutyType[DUTY_TYPES[kind]])
    datas = [duty_data(m, kind, slot, v) for v in range(n)]
    root = datas[0].signing_root(chain)
    h = native.hash_to_g2(root)
    shares = sorted(cluster["share_sk"][0])
    jobs = [(v, i) for v in range(n) for i in shares]
    sigs = dict(zip(jobs, pool.map(lambda t: native.lincomb_g2([h], [cluster["share_sk"][t[0]][t[1]]]),
                                   jobs)))
    if tamper is not None:
        other = native.hash_to_g2(hashlib.sha256(b"other" + root).digest())
        sigs[0, tamper] = native.lincomb_g2([other], [cluster["share_sk"][0][tamper]])
    pks = [m.types.pubkey_from_bytes(pk) for pk in cluster["root_pk"][:n]]
    sets = {i: {pks[v]: m.types.ParSignedData(datas[v].set_signature(sigs[v, i]), i)
                for v in range(n)} for i in shares}
    own = sets.pop(node)
    return duty, own, sets, root


def duty_keys(cluster: dict, n: int) -> keyshares.KeyShares:
    """Node 1's KeyShares of the first n validators."""
    return keyshares.KeyShares.from_bytes(
        1, THRESHOLD, {cluster["root_pk"][v]: cluster["share_pk"][v] for v in range(n)},
        {cluster["root_pk"][v]: cluster["share_sk"][v][1].to_bytes(32, "big") for v in range(n)})


def duty_chain() -> ES.ChainSpec:
    """The phase's chain (DutyNode.deliver sets its clock to each round)."""
    return ES.ChainSpec(genesis_time=time.time() - DUTY_SLOT0 * 12.0 - 6.0,
                        genesis_validators_root=hashlib.sha256(b"charon duty").digest())


def duty_expected(pool, cluster: dict, sets, n: int) -> dict:
    """{(duty, pubkey): the root key's native signature of the duty's
    signing root}."""
    out = {}
    for duty, own, _peers, root in sets:
        h = native.hash_to_g2(root)
        sigs = pool.map(lambda sk: native.lincomb_g2([h], [sk]), cluster["root_sk"][:n])
        out.update({(duty, pk): s for pk, s in zip(own, sigs)})
    return out


def _timed_chunk_planes(cache, record: list):
    inner = cache.chunk_planes

    def chunk_planes(pks, chunks, buckets, device):
        misses = cache.misses
        t0 = time.perf_counter()
        out = inner(pks, chunks, buckets, device)
        record.append((len(pks), cache.misses - misses, time.perf_counter() - t0))
        return out
    return chunk_planes


def _duty_round(node, pool, cluster, chain, n, slot, kinds, tamper=None, extra=()) -> tuple:
    """Sign one slot's duties (host), deliver them to the node, and hold
    every aggregate against the root key's native signature. Returns (the
    round's sets, {duty: verify wall}, {duty: sigagg latency}, the window's
    wall: the first set's delivery to the last aggregate stored and every
    inbound set handled)."""
    sets = [duty_sets(node.m, pool, cluster, chain, kind, s, n, tamper=tamper if j == 0 else None)
            for j, (kind, s) in enumerate([(k, slot) for k in kinds] + list(extra))]
    t0 = time.perf_counter()
    got = asyncio.run(node.deliver([s[:3] for s in sets]))
    window_s = time.perf_counter() - t0
    want = duty_expected(pool, cluster, sets, n)
    if got != want:
        bad = sorted(str(d) for (d, _pk), sig in got.items() if want.get((d, _pk)) != sig)
        raise SystemExit(f"duty back half: aggregates of {len(bad)} (duty, validator) pairs are "
                         f"not the root key's native signature: {bad[:4]}")
    duties = [s[0] for s in sets]
    return (sets, {d: node.verify_wall(d) for d in duties},
            {d: node.stored_at[d] - node.threshold_at[d] for d in duties}, window_s)


def verify_flushes(sets: int, n: int, flush_at: int) -> list:
    """A slot's verify flushes (submissions, items) when `sets` inbound sets
    of n partials each arrive at once: a flush at every count trigger, the
    remainder closed on the quorum or the timer."""
    k = -(-flush_at // n)       # sets that reach the count
    full, rest = divmod(sets, k)
    return [(k, k * n)] * full + ([(rest, rest * n)] if rest else [])


def duty_config(pool, cluster, label: str, n: int, kinds, slot: int, smi: str) -> tuple:
    """One config: DUTY_ROUNDS slots of its duties through node 1's back
    half, every count at 0 just before (the main path), then a slot with a
    tampered partial of peer 3 beside a second duty in the same window.
    Returns (path_counts of the main path, the config's JSON, the node)."""
    impl = TorchImpl()
    TB.set_implementation(impl)
    decodes: list = []
    impl.pk_cache.chunk_planes = _timed_chunk_planes(impl.pk_cache, decodes)
    chain = duty_chain()
    node = DutyNode(duty_modules(), duty_keys(cluster, n), chain)
    _duty, _own, peers, _root = duty_sets(node.m, pool, cluster, chain, kinds[0], slot, n)
    t0 = time.perf_counter()
    for s in peers.values():
        for p in s.values():
            p.data.signing_root(chain)
    roots_s = time.perf_counter() - t0
    CP.reset_counts()
    walls, lat, rounds = {}, {}, []
    for r in range(DUTY_ROUNDS):
        before = (len(node.flushes), len(decodes))
        _sets, w, lt, _window = _duty_round(node, pool, cluster, chain, n, slot + r, kinds)
        walls.update(w)
        lat.update(lt)
        rd = {"flushes": [(k, c, i, round(end - start, 6))
                          for k, c, i, start, end in node.flushes[before[0]:]],
              "pk_decode_s": sum(s for _n, miss, s in decodes[before[1]:] if miss),
              "pk_lookups_s": sum(s for _n, _m, s in decodes[before[1]:])}
        rounds.append(rd)
        log(f"duty {label} slot {r}: verify walls " + ", ".join(f"{x:.4f}" for x in w.values())
            + " s, sigagg latency " + ", ".join(f"{x:.4f}" for x in lt.values())
            + f" s; flushes (kind, submissions, items, s) {rd['flushes']}; pk planes decoded "
            f"{rd['pk_decode_s']:.4f} s, lookups {rd['pk_lookups_s']:.4f} s ({smi})")
    torch.cuda.synchronize()
    counts = path_counts()
    if node.errors:
        raise SystemExit(f"duty {label}: valid partials raised {node.errors[0][2]}")
    want = verify_flushes(len(kinds) * (NUM_SHARES - 1), n, node.co._ver.flush_at)
    got = [[(c, i) for k, c, i, _s in rd["flushes"] if k == "verify"] for rd in rounds]
    if any(g != want for g in got):
        raise SystemExit(f"duty {label}: verify flushes (submissions, items) {got}, not {want} "
                         f"a slot (the count trigger, then the quorum or the timer)")
    # a tampered partial of peer 3 (validator 0, the slot's first duty) beside
    # a second duty in the same window: the set is dropped with the
    # reference's error, attributed to share 3; both duties complete
    extra = () if len(kinds) > 1 else [(kinds[0], slot + DUTY_ROUNDS + 1)]
    # the window's failed flushes (verify_batch False) and their attribution
    # (verify_batch_each), counted through the facade's backend
    failed, each = [], []
    verify_batch, verify_batch_each = impl.verify_batch, impl.verify_batch_each

    def counted_verify(*args):
        ok = verify_batch(*args)
        failed.extend([] if ok else [len(args[0])])
        return ok

    def counted_each(*args):
        each.append(len(args[0]))
        return verify_batch_each(*args)

    impl.verify_batch, impl.verify_batch_each = counted_verify, counted_each
    t0 = time.perf_counter()
    node.errors.clear()
    flushed = len(node.flushes)
    try:
        sets, _w, _lt, window_s = _duty_round(node, pool, cluster, chain, n,
                                              slot + DUTY_ROUNDS, kinds, tamper=3, extra=extra)
    finally:
        impl.verify_batch, impl.verify_batch_each = verify_batch, verify_batch_each
    tampered_s = time.perf_counter() - t0
    t_first = node.flushes[flushed][3]
    tampered_flushes = [(k, c, i, round(a - t_first, 6), round(b - t_first, 6))
                        for k, c, i, a, b in node.flushes[flushed:]]
    if not failed or each != failed:
        raise SystemExit(f"duty {label}: the tampered window's failed flushes (items) {failed} "
                         f"were attributed by verify_batch_each calls (items) {each}, not one "
                         f"each")
    if window_s > DUTY_SLOT_S:
        raise SystemExit(f"duty {label}: the tampered window took {window_s:.4f} s, past the "
                         f"{DUTY_SLOT_S:.0f} s slot; flushes (kind, submissions, items, start, "
                         f"end) {tampered_flushes}")
    errs = [(d, s, str(e), getattr(e, "fields", {}).get("share_idx")) for d, s, e in node.errors]
    if len(errs) != 1 or errs[0][:2] != (sets[0][0], 3) or errs[0][3] != 3 \
            or "invalid partial signature" not in errs[0][2]:
        raise SystemExit(f"duty {label}: a tampered partial of peer 3 gave {errs}")
    lats = [lat[d] for d in sorted(lat)]
    out = {"validators": n, "duties": len(lat), "inbound_sets": len(lat) * (NUM_SHARES - 1),
           "flush_at": node.co._ver.flush_at,
           "signing_roots_s": roots_s, "signing_roots": (NUM_SHARES - 1) * n,
           "verify_wall_s": [walls[d] for d in sorted(walls)],
           "sigagg_latency_s": {"p50": statistics.median(lats), "max": max(lats), "runs": lats},
           "rounds": rounds, "tampered_slot_s": tampered_s, "tampered_error": errs[0][2],
           "tampered_window_s": window_s, "tampered_flushes": tampered_flushes,
           "tampered_failed_flush_items": failed, "tampered_each_items": each,
           "card": smi}
    log(f"duty {label} ({n} validators x {THRESHOLD}-of-{NUM_SHARES}, {', '.join(kinds)}; {smi}): "
        f"sigagg latency (threshold -> aggsigdb) p50 {out['sigagg_latency_s']['p50']:.4f} s, max "
        f"{out['sigagg_latency_s']['max']:.4f} s, runs " + ", ".join(f"{x:.4f}" for x in lats)
        + "; parsigex verify walls " + ", ".join(f"{x:.4f}" for x in out["verify_wall_s"]) + " s")
    log(f"duty {label}: host signing roots {roots_s:.4f} s for one duty's {(NUM_SHARES - 1) * n} "
        f"inbound partials ({smi})")
    log(f"duty {label}: a tampered partial of peer 3 raises {errs[0][2][:120]!r} (share 3), its "
        f"set dropped, both duties of the window complete, byte-identical; the tampered window "
        f"{window_s:.4f} s (the round with its host signing {tampered_s:.4f} s; {smi}), its "
        f"{len(failed)} failed flush(es) of {failed} items each attributed in one "
        f"verify_batch_each call; flushes (kind, submissions, items, start, end) "
        f"{tampered_flushes}")
    return counts, out, node


def duty_overlap(node, pool, cluster, n: int, slot: int, kind: str) -> dict:
    """While one duty's slot runs on the slot thread, a second duty's set
    (peer 2's partials of 64 validators) goes into the verify window, which
    must close on its 25 ms timer before that slot ends."""
    chain = node.agg._chain
    first = duty_sets(node.m, pool, cluster, chain, kind, slot, n)
    duty_b, _own, peers_b, _root = duty_sets(node.m, pool, cluster, chain, kind, slot + 1,
                                             min(64, n))

    async def run():
        started = asyncio.Event()
        node.on_flush = lambda k: k == "agg" and started.set()
        task = asyncio.ensure_future(node.deliver([first[:3]]))
        await started.wait()
        node.on_flush = None
        t_submit = time.perf_counter()
        await node.verify_set(duty_b, peers_b[2])
        await task
        return t_submit

    before = len(node.flushes)
    t_submit = asyncio.run(run())
    new = node.flushes[before:]
    slot_flush = next(f for f in new if f[0] == "agg")
    probe = next(f for f in new if f[0] == "verify" and f[3] >= t_submit)
    out = {"window_wait_s": probe[3] - t_submit, "slot_left_s": slot_flush[4] - probe[3],
           "slot_s": slot_flush[4] - slot_flush[3]}
    if probe[3] >= slot_flush[4]:
        raise SystemExit(f"duty overlap: a second duty's window closed {out['window_wait_s']:.4f} s "
                         f"after its submission, after the first duty's slot ended")
    log(f"duty overlap: a second duty's window closed {out['window_wait_s'] * 1e3:.1f} ms after its "
        f"submission (timer 25 ms), {out['slot_left_s']:.4f} s before the running slot "
        f"({out['slot_s']:.4f} s) ended")
    return out


def duty_phase(pool, smi: str) -> tuple[dict, dict]:
    """Phase 10: the back half of node 1 of a 4-of-6 cluster (seed 13) at
    each of DUTY_CONFIGS, through the port's tbls facade with TorchImpl()
    installed (fallback_on_device_error off): DUTY_ROUNDS fresh slots each,
    counts at 0 just before; every aggregate byte-identical to the root
    key's native signature; the verify window closed on the quorum of 5
    once a slot; the launches of the device slot, the device verify and the
    bulk verify's psi check; a tampered partial attributed; a second duty's
    window closing while a slot runs; the guard's counters 0. Returns (the
    main path's counts, the phase's JSON)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cluster = duty_cluster(pool, max(n for _l, n, _k in DUTY_CONFIGS))
    log(f"duty probe: {len(cluster['root_sk'])} validators x {THRESHOLD}-of-{NUM_SHARES} keys made "
        f"natively in {time.perf_counter() - t0:.1f} s")
    prev, guard0, ceremony0 = TB._impl, GD.counters(), dict(TF.FALLBACKS)
    counts, out = [], {}
    try:
        for c, (label, n, kinds) in enumerate(DUTY_CONFIGS):
            cnt, out[label], node = duty_config(pool, cluster, label, n, kinds,
                                                DUTY_SLOT0 + 16 * c, smi)
            counts.append(cnt)
            launched = {(k, E): sum(w for (e, _n), w in cnt["widths"][k].items() if e == E)
                        for k in CP.KERNELS for E in CP.KERNELS[k].variants}
            missing = [f"{k}<{E}>" for (k, E), x in launched.items()
                       if x == 0 and (k, E) not in OFF_PATH]
            off = [f"{k}<{E}>={launched[k, E]}" for k, E in OFF_PATH if launched[k, E]]
            x_abs = sum(x for (E, _w, k), x in cnt["cases"]["pt_mul_shared"].items()
                        if (E, k) == (2, PF.X_ABS))
            if missing or off or not x_abs:
                raise SystemExit(f"duty {label}: the main path launched no {missing}, and {off}; "
                                 f"pt_mul_shared<2> at X_ABS {x_abs} times")
            out[label]["launches"] = {f"{k}<{E}>": x for (k, E), x in launched.items() if x}
            log(f"duty {label} main path ({DUTY_ROUNDS} slots): launches "
                + ", ".join(f"{k}<{E}>={x}" for (k, E), x in launched.items() if x)
                + f"; pt_mul_shared<2> at X_ABS {x_abs}")
        out["overlap"] = duty_overlap(node, pool, cluster, DUTY_CONFIGS[-1][1],
                                      DUTY_SLOT0 + 16 * len(DUTY_CONFIGS), DUTY_CONFIGS[-1][2][0])
    finally:
        TB._impl = prev
    if GD.counters() != guard0 or dict(TF.FALLBACKS) != ceremony0:
        raise SystemExit(f"duty phase: the guard absorbed a device failure: {GD.counters()} "
                         f"(before: {guard0})")
    log("duty phase: no guard counter moved (fallback_on_device_error off)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"duty phase: {out['phase_s']:.1f} s ({smi})")
    return merge_counts(*counts), out


def _reduce_cases(n: int, G: int, device, E: int = 1) -> list:
    """[(label, (X, Y, Z), gid)] at width n and G groups, E = 1 or 2: the edge
    lanes (the scalar multiplications' pool, _mul_lanes(E): ∞, points of
    order 3, a G1 point plus one, at E = 2 embedded in Fq2 beside G2 points;
    in group 0 lanes 7 and 15 a point and its negation, lanes 8 and 16
    one point twice after the ∞ of lane 0, so that one accumulator of the
    kernel adds P + (−P) and another P + P; ids drawn below G - 1, so group
    G - 1 is empty where G > 1; the last eighth of the lanes padding, id
    -1), every lane padding (every group empty), and last the case that is
    timed: seeded multiples of the generator, lane i in group i % G, as the
    ceremony's chunks (at E = 2 G2 points, the combined MSM's groups being
    its signature lanes and each message's embedded pk lanes)."""
    pool = _mul_lanes(E)
    rng = random.Random(f"reduce {n} {G}")
    gid = [rng.randrange(max(G - 1, 1)) for _ in range(n)]
    pts = [pool[i % 16] for i in range(n)]
    if n > 16:
        y = pool[7][1]
        neg = (pool[7][0], (-y) % PF.P if E == 1 else tuple((-c) % PF.P for c in y), pool[7][2])
        pts[7], pts[15], pts[8], pts[16] = pool[7], neg, pool[8], pool[8]
        for i in (0, 7, 15, 8, 16):
            gid[i] = 0
    pad = n - n // 8 if n >= 8 else n
    gid[pad:] = [-1] * (n - pad)
    general = [pool[6 + i % 10] for i in range(n)]
    out = []
    for label, ps, ids in (("edge lanes", pts, gid), ("all padding", pts, [-1] * n),
                           ("general lanes", general, [i % G for i in range(n)])):
        planes = tuple(CV.port_from_ints([p[c] for p in ps], E, device) for c in range(3))
        out.append((label, planes, torch.tensor(ids, dtype=torch.int32, device=device)))
    return out


def check_reduce(device, cases: dict, reps: int = 0) -> dict:
    """pt_reduce_groups<E> bit for bit (X, Y, Z words) against its plain
    version at each case (E, width, G) -> launches, on _reduce_cases'
    inputs; with reps the general lanes are timed (device us back to back,
    host wall, the plain version's wall). Bound: the lanes' points and ids
    read once and the G sums written, against one pt_add<E> a lane in a
    group. Returns per E the JSON row of its most launched case, every case
    in by_width."""
    timed: dict = {}
    for (E, n, G), launches in sorted(cases.items(), key=lambda kv: -kv[1]):
        for label, pts, gid in _reduce_cases(n, G, device, E):
            tag = f"pt_reduce_groups<{E}> n={n} G={G} ({label})"
            got = CP.reduce_groups(*pts, gid, G, E)
            err = _hold(tag, got, C.pt_reduce_groups_plain(*pts, gid, G, E))
            if label != "general lanes" or not reps:
                log(f"kernel {tag}: bit-equal to plain (X, Y, Z words)")
                continue
            members = int(((gid >= 0) & (gid < G)).sum().item())
            bound_ms, by = _bound(n * (3 * E * 48 + 4) + 3 * E * 48 * G,
                                  members * point_ops("pt_add", E))
            row = {"width": n, "groups": G, "launches": launches,
                   "ms": _time_ms(lambda: CP.reduce_groups(*pts, gid, G, E), reps),
                   "wall_ms": _wall_ms(lambda: CP.reduce_groups(*pts, gid, G, E), reps),
                   "plain_ms": _wall_ms(lambda: C.pt_reduce_groups_plain(*pts, gid, G, E), 1),
                   "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
            timed.setdefault(E, []).append(row)
            log(f"kernel {tag}: bit-equal to plain (max_abs_err 0); {launches} calls on the "
                f"main path; {row['ms'] * 1e3:.1f} us a call (two launches; host wall "
                f"{row['wall_ms'] * 1e3:.1f} us); plain {row['plain_ms']:.1f} ms; bound "
                f"{bound_ms * 1e3:.3f} us ({by})")
    torch.cuda.synchronize()
    return {("pt_reduce_groups", E): {
        "name": f"pt_reduce_groups<{E}>", "route": "cuda",
        "source": CP.KERNELS["pt_reduce_groups"].source,
        "replaces": CP.KERNELS["pt_reduce_groups"].site(E), "launches": 0, "library_ms": None,
        **{k: rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "width", "groups")},
        "by_width": [{k: v for k, v in r.items() if k not in ("bound_by", "max_abs_err")}
                     for r in rows]} for E, rows in timed.items()}


def merge_counts(*runs) -> dict:
    """path_counts of several runs, added."""
    out = {"widths": {}, "cases": {}}
    for run in runs:
        for part in ("widths", "cases"):
            for name, counts in run[part].items():
                acc = out[part].setdefault(name, collections.Counter())
                acc.update(counts)
    return {part: {name: dict(c) for name, c in d.items()} for part, d in out.items()}


def rfc_vector(device) -> None:
    hx, hy = H2C.hash_to_g2_device([b""], device, dst=RFC_DST)
    x0, x1, y0, y1 = F.fq_ints(torch.stack([hx, hy], 1).cpu().numpy())
    if ((x0, x1), (y0, y1)) != RFC_P:
        raise SystemExit("device hash-to-G2 misses the RFC 9380 J.10.1 vector")
    log("RFC 9380 J.10.1 (msg '') through the device hash-to-G2: exact")


def profile_slot(impl: TorchImpl, batches, pubkeys, datas) -> None:
    """One warm slot under torch.profiler: device time by kernel and the
    device's busy share of the slot's wall time, from the trace's device
    activities (kernels, copies, memsets; their intervals merged)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/slot_trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    spans, by_name = [], {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            spans.append((ts, ts + dur))
            us, count = by_name.get(ev["name"], (0.0, 0))
            by_name[ev["name"]] = (us + dur, count + 1)
    if not spans:
        raise SystemExit("profile: the trace holds no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy = busy_us / 1e6
    log(f"profile: slot wall {wall:.4f} s (traced), device busy {busy:.4f} s "
        f"= {busy / wall:.3f} of the wall, idle share {1 - busy / wall:.3f}")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  device {us / 1e3:9.3f} ms  {count:6d} x  {name[:90]}")


# ---------------------------------------------------------------------------
# A/B of kernel builds (--ab)
# ---------------------------------------------------------------------------

AB_DIR = os.path.join(CP.BUILD_DIR, "ab")
# (pattern, replacement) in plane_kernels.cu's level loop, per diagnostic
_OPERATION = """            operand<T>(x, sm, op >> 8 & 0xff, op >> 16 & 0xff, flags & 1, pt);
            operand<T>(y, sm, op >> 24 & 0xff, op >> 32 & 0xff, flags & 2, pt);
            if (mul) {
                fq_slice<T>(r, y, g);
                mul_split<T>(r, x, r, g);
                if (k < count) sstore_slice<T>(sm, op & 0xff, pt, r, g);
            } else {
                fq_addsub(z, x, y, flags & 4);
                sstore(sm, op & 0xff, pt, z);
            }"""
# and in pt_mul_windowed's operation and level loop
_WIN_OPERANDS = """    win_operand<E, P, T>(x, sm, op >> 8 & 0xff, op >> 16 & 0xff, flags & 1, qb);
    win_operand<E, P, T>(y, sm, op >> 24 & 0xff, op >> 32 & 0xff, flags & 2, qb);
"""
DIAGNOSTICS = {
    "no-arith": [(_OPERATION, """            sload(z, sm, op >> 8 & 0xff, pt);
            sstore(sm, op & 0xff, pt, z);"""),
                 (_WIN_OPERANDS, """    win_load<P>(z, win_slot<E, P, T>(sm, op >> 8 & 0xff, qb));
    win_store<P, T>(win_slot<E, P, T>(sm, op & 0xff, qb), z);
    return;
""")],
    "no-linear": [("for (int k = rank; k < end; k += G)",
                   "for (int k = rank; mul && k < end; k += G)"),
                  ("for (int k = rank; k < count; k += R)",
                   "for (int k = rank; mul && k < count; k += R)")],
    "no-products": [("""                fq_slice<T>(r, y, g);
                mul_split<T>(r, x, r, g);
                if (k < count) sstore_slice<T>(sm, op & 0xff, pt, r, g);""",
                     """                fq_addsub(z, x, y, false);
                sstore(sm, op & 0xff, pt, z);"""),
                    ("    if constexpr (T > 1) {\n        if (mul) {",
                     "    if constexpr (false) {\n        if (mul) {"),
                    ("        fq_mul(z, x, y);", "        fq_addsub(z, x, y, false);")],
}


def ab_source(src: str, constants: dict, patches=()) -> str:
    """plane_kernels.cu's text with its `constexpr int NAME = V;` lines set
    from constants and each (old, new) patch applied; ValueError unless each
    occurs exactly once."""
    for name, value in constants.items():
        pattern = re.compile(rf"^constexpr int {re.escape(name)} = \d+;$", re.M)
        if len(pattern.findall(src)) != 1:
            raise ValueError(f"the kernel source has no single `constexpr int {name}`")
        src = pattern.sub(f"constexpr int {name} = {int(value)};", src)
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"the kernel source has no single {old!r}")
        src = src.replace(old, new)
    return src


def _ab_build(name: str, src_dir: str, constants: dict, patches) -> tuple:
    """nvcc one variant into AB_DIR; returns (name, library path, nvcc log)."""
    with open(os.path.join(src_dir, "plane_kernels.cu")) as f:
        src = ab_source(f.read(), constants, patches)
    cu = os.path.join(AB_DIR, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(AB_DIR, f"lib{name}.so")
    proc = subprocess.run([CP.nvcc(), *CP.NVCC_FLAGS, "-I", os.path.abspath(src_dir), "-I", AB_DIR,
                           "-o", lib, cu], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return name, lib, proc.stdout + proc.stderr


def ab_rows(libs: dict, reps: int, dev) -> None:
    """Rows kernels of every variant in turns, each held against its plain
    version: fe_mul_rows<1> and fe_add_rows (also at n_add = 0) at
    ROWS_WIDTHS rows, fe_mul_rows<2> at FQ2_TIMED products (launched
    through each library's C interface, which leaves the launch counters
    alone)."""
    rng = random.Random(2468)
    names = [n for n in libs if n not in DIAGNOSTICS]
    cases = [(kernel, n, E, plain, args) for n in ROWS_WIDTHS
             for kernel, E, plain, args in (("fe_mul_rows", 1, F.rows_mul_plain, (1,)),
                                            ("fe_add_rows", 1, F.rows_add_plain, (n,)),
                                            ("fe_add_rows", 1, F.rows_sub_plain, (0,)))]
    cases += [("fe_mul_rows", k, 2, F.rows_mul2_plain, (2,)) for k in FQ2_TIMED]
    for kernel, n, E, plain, args in cases:
        a, b = _rand_rows(rng, n, dev, E), _rand_rows(rng, n, dev, E)
        want, out = plain(a, b), torch.empty_like(a)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            def fn(fn=getattr(libs[name], "charon_" + kernel)):
                if fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, *args,
                      torch.cuda.current_stream().cuda_stream):
                    raise SystemExit(f"{name} {kernel}<{E}> did not launch")
            fn()
            _hold(f"{name} {kernel}<{E}> n={n}", (out,), (want,))
            times[name].append(_time_ms(fn, reps) * 1e3)
        label = f"{kernel}<{E}>" if kernel == "fe_mul_rows" else f"{kernel} n_add={args[0]}"
        log(f"rows A/B {label} n={n}: " + "; ".join(
            f"{name} {sum(t) / len(t):.2f}" for name, t in times.items()) + " us")


# fe_pow's A/B cases: (layout, width, exponent)
POW_AB = (("plane", 12288, "e34"), ("plane", 4096, "e34"), ("plane", 1024, "e34"),
          ("rows", 1, "inv"), ("rows", 2, "inv"), ("rows", 6, "sqrt"), ("rows", 8, "inv"))


def ab_pow(libs: dict, reps: int, dev) -> None:
    """fe_pow of every variant in turns at POW_AB, each held bit for bit
    against its plain version (through each library's C interface)."""
    names = [n for n in libs if n not in DIAGNOSTICS]
    for layout, n, ename in POW_AB:
        _lay, _n, digits = pow_case(layout, n, ename)
        a = _pow_input(layout, n, dev, f"ab {layout} {n}")
        mul = (lambda x, y: F.fe_mul_plain(x, y, 1)) if layout == "plane" else F.rows_mul_plain
        want, out = F.pow_plain(a, list(digits), mul), torch.empty_like(a)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            def fn(fn=libs[name].charon_fe_pow):
                if fn(CP.POW_LAYOUTS[layout], a.data_ptr(), out.data_ptr(), n, bytes(digits),
                      len(digits), torch.cuda.current_stream().cuda_stream):
                    raise SystemExit(f"{name} fe_pow<{layout}> did not launch")
            fn()
            _hold(f"{name} fe_pow<{layout}> n={n}", (out,), (want,))
            times[name].append(_time_ms(fn, reps) * 1e3)
        log(f"fe_pow A/B <{layout}> n={n} e={ename}: " + "; ".join(
            f"{name} {sum(t) / len(t):.1f}" for name, t in times.items()) + " us")


# the composites' A/B cases: (kernel, E, width, k or windows), the main
# path's
MUL_AB = (("pt_mul_windowed", 2, 4096, 64), ("pt_mul_windowed", 2, 2048, 16),
          ("pt_mul_windowed", 1, 1024, 16),
          ("pt_mul_shared", 1, 1024, U2), ("pt_mul_shared", 2, 1, PC.H_EFF_G2),
          ("pt_mul_shared", 2, 64, PC.H_EFF_G2))


def ab_uncovered(cases: dict) -> list:
    """The (kernel, layout or E, width or level shape) at which `cases`
    (path_counts()["cases"] of a run) launched fe_pow, pt_mul_shared or a
    field kernel and POW_AB / MUL_AB / FE_AB time none, in order."""
    timed = {("fe_pow", lay, n) for lay, n, _e in POW_AB} | \
        {(name, E, n) for name, E, n, _k in MUL_AB} | set(FE_AB)
    launched = ({("fe_pow", lay, n) for lay, n, _d in cases.get("fe_pow", {})}
                | {("pt_mul_shared", E, n) for E, n, _k in cases.get("pt_mul_shared", {})}
                | set(fe_cases(cases)))
    return sorted(launched - timed, key=str)


def ab_mul(libs: dict, reps: int, dev) -> None:
    """pt_mul_shared and pt_mul_windowed of every variant in turns at
    MUL_AB, each held bit for bit against its plain version (through each
    library's C interface); the --diagnose builds, whose outputs are wrong
    by design, are timed only."""
    names = list(libs)
    for name, E, n, arg in MUL_AB:
        _label, pts, digits = _mul_cases(name, E, n, arg, dev)[-1]
        a = arg if digits is None else digits
        want = mul_plain(name, E, pts, a)
        args = ((CP.scalar_bits(arg), arg.bit_length()) if digits is None
                else (digits.data_ptr(), digits.shape[0]))
        times = {nm: [] for nm in names}
        for nm in names + names[::-1]:
            def fn(lib=libs[nm]):
                return CP.call(lib, name, E, pts, 3, args)
            if nm not in DIAGNOSTICS:
                _hold(f"{nm} {name}<{E}> n={n}", fn(), want)
            times[nm].append(_time_ms(fn, reps) * 1e3)
        log(f"{name}<{E}> A/B n={n} {'windows' if digits is not None else 'bits'}="
            f"{arg if digits is not None else arg.bit_length()}: " + "; ".join(
                f"{nm} {sum(t) / len(t):.1f}" for nm, t in times.items()) + " us")


# the field kernels' A/B cases: every level of the headline slot (1,024
# validators a bucket, 4,096 partials), and single products at the widths
# where the split and one thread a product may cross
FE_AB = tuple(sorted(slot_levels(1024, 4096), key=str)) + (
    ("fe_mul", 1, (2048,)), ("fe_mul", 1, (8192,)), ("fe_mul", 1, (12288,)),
    ("fe_mul", 2, (2048,)), ("fe_mul", 2, (8192,)))
_LEGACY = {"add": "fe_add", "sub": "fe_sub", "neg": "fe_sub"}


def _legacy_fe(lib, kernel: str, E: int, ops):
    """A level on a library from before the level kernels: one launch an
    operation, charon_fe_mul / fe_add / fe_sub(E, a, b, o, n, stream) on
    contiguous copies of the operands (a negation 0 - b), made here, outside
    the timed launches. Returns (a launch-only fn, the outputs)."""
    calls, outs = [], []
    for op in ops:
        a, b = op if kernel == "fe_mul" else op[1:]
        a = torch.zeros_like(b) if a is None else a.contiguous()
        b, o = b.contiguous(), torch.empty_like(b.contiguous())
        fn = getattr(lib, "charon_" + ("fe_mul" if kernel == "fe_mul" else _LEGACY[op[0]]))
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        calls.append((fn, a, b, o))
        outs.append(o)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for fn, a, b, o in calls:
            if fn(E, a.data_ptr(), b.data_ptr(), o.data_ptr(), b.shape[2], stream):
                raise SystemExit(f"{kernel}<{E}> did not launch")
    return run, outs


def ab_fe(libs: dict, reps: int, dev) -> None:
    """fe_mul and fe_addsub of every variant in turns at FE_AB, each held
    bit for bit against its plain version: a level launch through the
    library's C interface (call_level, no counting), or on a library from
    before the level kernels one launch an operation on contiguous copies
    made outside the timed launches."""
    names = [n for n in libs if n not in DIAGNOSTICS]
    for kernel, E, shape in FE_AB:
        label = fe_label(kernel, E, shape)
        ops = fe_level(kernel, E, shape, dev, f"ab {label}")
        want = fe_plain(kernel, E, ops)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            lib = libs[name]
            if hasattr(lib, "charon_fe_mul_level"):
                full = ops if kernel == "fe_addsub" else [(None, a, b) for a, b in ops]
                _d, segs, outs, _key = CP.level_args(kernel, full, E, None)

                def fn(lib=lib, segs=segs):
                    CP.call_level(lib, kernel, E, segs)
            elif hasattr(lib, "charon_fe_mul"):
                fn, outs = _legacy_fe(lib, kernel, E, ops)
            else:
                raise SystemExit(f"{name}: the library has no field kernel launcher")
            fn()
            _hold(f"{name} {label}", outs, want)
            times[name].append(_time_ms(fn, reps) * 1e3)
        log(f"fe A/B {label}: " + "; ".join(
            f"{name} {sum(t) / len(t):.2f}" for name, t in times.items()) + " us")


def _quartiles(xs: list) -> str:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"median {statistics.median(xs):.4f} (quartiles {q1:.4f}-{q3:.4f})"


def ab_points(libs: dict, widths, reps: int) -> None:
    rng = random.Random(4242)
    for E in (2, 1):
        cases = []
        for n in widths:
            pts = _point_cases(rng, E, n, torch.device("cuda:0"))[0][1]
            cases.append((n, "no P+P", _without_pp(pts)) if n >= 16 else (n, "", pts))
            if n == 4096:
                cases.append((n, "edges", pts))
        for n, label, pts in cases:
            for kernel, plain in (("pt_double", C.pt_double_plain), ("pt_add", C.pt_add_plain)):
                ins = pts if kernel == "pt_add" else pts[:3]
                want = plain(*ins, E)
                times = {name: [] for name in libs}
                for name in list(libs) + list(libs)[::-1]:
                    def fn(lib=libs[name]):
                        return CP.call(lib, kernel, E, ins, 3)
                    if name not in DIAGNOSTICS and _max_abs_err(fn(), want):
                        raise SystemExit(f"{name} {kernel}<{E}> disagrees with its plain "
                                         f"version at {n} lanes ({label})")
                    times[name].append(_time_ms(fn, reps) * 1e3)
                log(f"{kernel}<{E}> n={n} {label}: " + "; ".join(
                    f"{name} {sum(t) / len(t):.2f}" for name, t in times.items()) + " us")


def ab_slots(libs: dict, rounds: int) -> None:
    """Rounds of the headline slot with each variant's library in turn: the
    kernel wrappers launch from whichever library is bound last."""
    names = [n for n in libs if n not in DIAGNOSTICS]
    with ThreadPoolExecutor(max_workers=8) as pool:
        batches, pubkeys, _jobs = gen_cluster(pool)
    datas = [MSG] * N_VALIDATORS
    dev, nat = TorchImpl(), TorchImpl(verify="native")
    metrics = ("device slot", "device verify", "native slot", "sweep + combine", "MSM",
               "first verify")
    got = {name: {m: [] for m in metrics} for name in names}
    want = None
    for r in range(-1, rounds):                 # round -1 warms both caches
        for name in (names if r % 2 else names[::-1]):
            CP._lib[:] = [libs[name]]
            t = {}
            for m, impl in (("device slot", dev), ("native slot", nat)):
                t0 = time.perf_counter()
                aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
                t[m] = time.perf_counter() - t0
                if impl is dev:
                    t["device verify"] = dev.last_times.verify
                want = want or [bytes(a) for a in aggs]
                if not ok or [bytes(a) for a in aggs] != want:
                    raise SystemExit(f"{name}: slot verdict {ok} or aggregates differ")
            steps = {step: ms for step, _n, ms in first_slot_steps(batches, pubkeys, datas,
                                                                    dev.device)}
            t["sweep + combine"] = steps["Lagrange sweep + combine"] / 1e3
            t["MSM"] = steps["combined RLC MSM + reduction trees"] / 1e3
            t["first verify"] = steps["device verify (H(m) hashed)"] / 1e3
            if r >= 0:
                for m in metrics:
                    got[name][m].append(t[m])
    CP._lib.clear()
    for m in metrics:
        log(f"slot A/B {m} ({rounds} rounds, s): " + "; ".join(
            f"{name} {_quartiles(got[name][m])}" for name in names))
        for other in names[1:]:
            wins = sum(b < a for a, b in zip(got[names[0]][m], got[other][m]))
            log(f"  {other} faster than {names[0]} in {wins} of {rounds} pairs; runs "
                + "; ".join(f"{name} " + ", ".join(f"{v:.4f}" for v in got[name][m])
                            for name in (names[0], other)))


def variant_jobs(specs: list[str]) -> list:
    """NAME=DIR[:CONST=V,...] specs -> _ab_build's (name, dir, constants,
    patches) jobs; none given: this checkout's source as "new"."""
    jobs = []
    for v in specs:
        name, _, rest = v.partition("=")
        src_dir, _, consts = rest.partition(":")
        jobs.append((name, src_dir, dict(c.split("=", 1) for c in consts.split(",") if c), ()))
    return jobs or [("new", CP.CSRC, {}, ())]


def ab_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py --ab")
    ap.add_argument("variants", nargs="*", help="NAME=DIR[:CONST=V,...]")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--slot-rounds", type=int, default=0)
    ap.add_argument("--widths", default=",".join(map(str, POINT_WIDTHS)))
    ap.add_argument("--kernels", default="points,rows,pow,mul,fe")
    args = ap.parse_args(argv)
    groups = set(args.kernels.split(","))
    jobs = variant_jobs(args.variants)
    if args.diagnose:
        jobs += [(name, CP.CSRC, {}, patches) for name, patches in DIAGNOSTICS.items()]
    log(nvidia_smi_line())
    os.makedirs(AB_DIR, exist_ok=True)
    with open(os.path.join(AB_DIR, "point_schedule.h"), "w") as f:
        f.write(PS.header())
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda job: _ab_build(*job), jobs))
    libs = {}
    for name, path, text in built:
        for row in ptxas_summary(text):
            log(f"ptxas {name}: {row}")
        libs[name] = CP.bind(path, strict=False)
    if "fe" in groups:
        ab_fe(libs, 50, torch.device("cuda:0"))
    if "points" in groups:
        ab_points(libs, [int(w) for w in args.widths.split(",")], reps=50)
    if "rows" in groups:
        ab_rows(libs, 50, torch.device("cuda:0"))
    if "pow" in groups:
        ab_pow(libs, 10, torch.device("cuda:0"))
    if "mul" in groups:
        ab_mul(libs, 3, torch.device("cuda:0"))
    if args.slot_rounds:
        ab_slots(libs, args.slot_rounds)
    log(nvidia_smi_line())
    return 0


def sass_opcodes(sass: str) -> dict:
    """Per kernel of a `cuobjdump -sass` listing: its opcodes' counts (the
    mnemonic without modifiers)."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def duty_main(argv: list[str]) -> int:
    """--duty: build the kernels and run phase 10 alone; prints the duty
    JSON. A process that launched no kernel before pays the first launches
    in its first slot."""
    argparse.ArgumentParser(prog="chip_smoke.py --duty").parse_args(argv)
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    CP.build(force=True)
    with ThreadPoolExecutor(max_workers=8) as pool:
        _counts, duty = duty_phase(pool, smi)
    print(json.dumps({"duty": duty}, default=str))
    return 0


def sass_main(argv: list[str]) -> int:
    """--sass [--out DIR] [NAME=DIR[:CONST=V,...] ...]: build each variant as
    --ab does and write its `cuobjdump -sass` listing to DIR/NAME.sass;
    print ptxas's registers and each fe_pow, scalar-multiplication and
    fe_mul<1> kernel's instruction count and commonest opcodes."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py --sass")
    ap.add_argument("variants", nargs="*", help="NAME=DIR[:CONST=V,...]")
    ap.add_argument("--out", default=os.path.join(CP.BUILD_DIR, "sass"))
    args = ap.parse_args(argv)
    jobs = variant_jobs(args.variants)
    log(nvidia_smi_line())
    os.makedirs(AB_DIR, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(AB_DIR, "point_schedule.h"), "w") as f:
        f.write(PS.header())
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda job: _ab_build(*job), jobs))
    tool = os.path.join(os.path.dirname(CP.nvcc()), "cuobjdump")
    for name, path, text in built:
        for row in ptxas_summary(text):
            log(f"ptxas {name}: {row}")
        sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", path],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        with open(os.path.join(args.out, f"{name}.sass"), "w") as f:
            f.write(sass)
        for fn, ops in sass_opcodes(sass).items():
            # fe_mul_kernel<1> is one fq_mul with its loads and stores: the
            # product's instructions
            if any(k in fn for k in ("fe_pow", "pt_mul_shared", "pt_mul_windowed",
                                     "fe_mul_kernelILi1E")):
                log(f"sass {name} {fn}: {sum(ops.values())} instructions; " + ", ".join(
                    f"{op} {c}" for op, c in ops.most_common(14)))
    return 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    # phases 1-8 and the A/B: a device error fails the run, it never lands on
    # the native rung (phase 9 turns the fallback on for its own TorchImpls)
    TorchImpl.fallback_on_device_error = False
    if argv[:1] == ["--ab"]:
        return ab_main(argv[1:])
    if argv[:1] == ["--sass"]:
        return sass_main(argv[1:])
    if argv[:1] == ["--duty"]:
        return duty_main(argv[1:])
    device = torch.device("cuda:0")
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    walls, t_mark = {}, [time.perf_counter()]

    def mark(name: str) -> None:
        """The command time since the last mark, under `name`."""
        now = time.perf_counter()
        walls[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    CP.build(force=True)
    log(f"build: nvcc {' '.join(CP.NVCC_FLAGS)} in {CP.BUILD.seconds:.1f} s")
    for row in ptxas_summary(CP.BUILD.log):
        log(f"  ptxas {row}")

    # the field levels' gate: edges, ragged and strided segments, both
    # widths of the products' split; they are timed at the main path's
    # levels below, beside the launch floor
    check_fe(device, {c: 0 for c in FE_GATE})
    floor_ms = launch_floor_ms()
    log(f"launch floor: an empty kernel {floor_ms * 1e3:.2f} us/launch (back to back behind "
        f"the sleep, as every kernel is timed)")
    rows = {}
    # the point ops at every width the main path launched them before the
    # scalar multiplications took their chains: the sweep (4096), the MSM
    # (2048), the combine and the pk subgroup check (1024), the MSM's
    # reduction tree (512-128), hash-to-G2's q0 + q1 at 64 and 1; the JSON
    # row of each is the width the slot launches it most (pt_add<2>: the
    # combine's), or where it launches it no more the sweep's (G2) or the
    # subgroup check's (G1)
    pt_rows = check_point_kernels(device, POINT_WIDTHS, reps=50)
    for name in ("pt_double", "pt_add"):
        for E, main_width in ((1, 1024), (2, 4096)):
            rows[(name, E)] = dict(pt_rows[(name, E, main_width)], by_width=[
                {k: pt_rows[(name, E, n)][k] for k in ("width", "ms", "plain_ms", "bound_ms")}
                for n in POINT_WIDTHS])
    # the rows kernels' and fe_pow's gates; they are timed at the main
    # path's widths below
    check_rows_kernels(device, {key: dict.fromkeys(keys, 0) for key, keys in ROWS_GATE.items()})
    log(pow_shape())
    check_pow(device, {pow_case(*c): 0 for c in POW_GATE})
    check_mul(device, {c: 0 for c in MUL_GATE})

    mark("build, kernel gates")
    with ThreadPoolExecutor(max_workers=8) as pool:
        t0 = time.perf_counter()
        batches, pubkeys, jobs = gen_cluster(pool)
        log(f"probe: {N_VALIDATORS} validators x {THRESHOLD}-of-{NUM_SHARES} signed natively "
            f"in {time.perf_counter() - t0:.1f} s")
        impl = TorchImpl()
        datas = [MSG] * N_VALIDATORS
        slot = run_slot(impl, batches, pubkeys, datas, pool)
        if ab_uncovered(slot["cases"]):
            raise SystemExit(f"--ab times fe_pow / pt_mul_shared at none of "
                             f"{ab_uncovered(slot['cases'])}, where the slot launched them")
        for (name, E), row in list(rows.items()):
            launched = {n: c for (e, n), c in slot["widths"][name].items() if e == E}
            if name in ("pt_double", "pt_add") and launched:
                top = max(launched, key=launched.get)
                rows[(name, E)] = dict(pt_rows[(name, E, top)], by_width=row["by_width"])
        rows.update(check_fe(device, fe_cases(slot["cases"]), reps=50, floor_ms=floor_ms))
        rows.update(check_rows_kernels(device, path_rows_cases(slot), reps=50))
        rows.update(check_pow(device, {**{pow_case(*c): 0 for c in POW_GATE},
                                       **slot["cases"]["fe_pow"]}, reps=20))
        rows.update(check_mul(device, mul_cases(slot["cases"]), reps=3))
        # the MSM's group sums, pt_reduce_groups<2>, at the slot's width
        rows.update(check_reduce(device, slot["cases"]["pt_reduce_groups"], reps=20))
        native_twin(batches, pubkeys, datas, slot["tampered"])
        S, live = slot_pairs(impl, batches, pubkeys, datas)
        verify_launches(TorchImpl(), S, live, "first (H(m) miss)")
        steady = verify_launches(impl, S, live, "steady (H(m) cached)")
        verify_host_ops(impl, S, live)
        if sum(steady.values()) > STEADY_VERIFY_MAX_LAUNCHES:
            raise SystemExit(f"a steady device verify launched {sum(steady.values())} kernels, "
                             f"more than {STEADY_VERIFY_MAX_LAUNCHES}")
        # the cases the committee slot and the chunked check launched that
        # the headline slot did not (h2c's scans, the tower and the cofactor
        # clear at 64 messages, the pairing at 65 and 1,040 pairs), held and
        # timed too
        mark("slot and its holds")
        committee = committee_slot(pool, jobs, pubkeys)
        more_rows, more = other_cases(committee, slot)
        for key, row in {**check_fe(device, fe_cases(more), reps=50, floor_ms=floor_ms),
                         **check_rows_kernels(device, more_rows, reps=50),
                         **check_pow(device, more["fe_pow"], reps=20),
                         **check_mul(device, mul_cases(more), reps=3),
                         **check_reduce(device, more["pt_reduce_groups"], reps=20)}.items():
            rows[key]["committee_by_width"] = row["by_width"]
        # the bulk verify, then every case it launched that the headline
        # slot and the committee phase did not (pt_mul_shared<2> at X_ABS,
        # the chunks' field levels, fe_pow and pt_mul_windowed<2> widths,
        # the pairing and hash-to-G2 at 2 messages), held and timed
        mark("committee and its holds")
        bulk_counts = bulk_verify(pool, smi)
        bulk_rows, bulk = other_cases(bulk_counts, merge_counts(slot, committee))
        for key, row in {**check_fe(device, fe_cases(bulk), reps=50, floor_ms=floor_ms),
                         **check_rows_kernels(device, bulk_rows, reps=50),
                         **check_pow(device, bulk["fe_pow"], reps=20),
                         **check_mul(device, mul_cases(bulk), reps=3),
                         **check_reduce(device, bulk["pt_reduce_groups"], reps=20)}.items():
            rows.setdefault(key, row)["bulk_verify_by_width"] = row["by_width"]
        mark("bulk verify and its holds")
        pipeline_phase(pool, jobs, pubkeys, smi)
        mark("pipeline")
        # the DKG, then every case it launched that phases 4-6 did not (the
        # E = 1 windowed sweeps, the G1 check, decompression and affine
        # form at the chunks' buckets, every group reduction), held and timed
        dkg_launches, dkg_main, dkg, dkg_items = dkg_phase(pool, smi, device)
        _rows, more = other_cases(dkg, merge_counts(slot, committee, bulk_counts))
        # each case at the launches of the DKG's main path (0: the soundness
        # or mixed-point cases only)
        more = {name: {k: dkg_main["cases"].get(name, {}).get(k, 0) for k in keys}
                for name, keys in more.items()}
        for key, row in {**check_fe(device, fe_cases(more), reps=50, floor_ms=floor_ms),
                         **check_pow(device, more["fe_pow"], reps=20),
                         **check_mul(device, mul_cases(more), reps=3),
                         **check_reduce(device, more["pt_reduce_groups"], reps=20)}.items():
            rows.setdefault(key, row)["dkg_by_width"] = row["by_width"]
        # no device failure may have been absorbed by phases 1-8; then the
        # guard itself, faults planned
        mark("dkg and its holds")
        guard_quiet("phases 1-8")
        guard = guard_phase(pool, batches, pubkeys, slot["tampered"], slot["launches"],
                            dkg_items, smi, device)
        # the duty pipeline's back half, then every case it launched that
        # phases 4-8 did not (the slot and the verify chunks at its widths),
        # held and timed
        mark("guard")
        duty_counts, duty = duty_phase(pool, smi)
        _rows, more = other_cases(duty_counts, merge_counts(slot, committee, bulk_counts, dkg))
        for key, row in {**check_fe(device, fe_cases(more), reps=50, floor_ms=floor_ms),
                         **check_rows_kernels(device, _rows, reps=50),
                         **check_pow(device, more["fe_pow"], reps=20),
                         **check_mul(device, mul_cases(more), reps=3),
                         **check_reduce(device, more["pt_reduce_groups"], reps=20)}.items():
            rows.setdefault(key, row)["duty_by_width"] = row["by_width"]
        mark("duty and its holds")
    rfc_vector(device)
    torch.cuda.synchronize()
    if "--profile" in argv:
        profile_slot(impl, batches, pubkeys, [MSG] * N_VALIDATORS)

    # a row keyed (kernel, E) takes the kernel's launches under E in the
    # headline slot, or where the slot launches it not at all in the DKG's
    # main path (pt_mul_windowed<1>, pt_reduce_groups<1>); an fe_addsub row,
    # keyed by its operation too, the launches of the levels that hold it,
    # which check_fe counted
    kernels = [dict(row, launches=slot["launches"][key] or dkg_launches[key])
               if key in slot["launches"] else row for key, row in rows.items()]
    for key, row in zip(rows, kernels):
        for w in row.get("by_width", ()):
            w.setdefault("launches", slot["widths"][key[0]].get((key[1], w["width"]), 0))
        # the launches under (kernel, E) of phase 10's main path
        row["duty_launches"] = sum(c for (e, _n), c in duty_counts["widths"][key[0]].items()
                                   if e == key[1])
    log(f"command time by phase, s: {walls}")
    log(smi)
    print(json.dumps({"duty": duty}, default=str))
    print(json.dumps({"guard": guard}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
