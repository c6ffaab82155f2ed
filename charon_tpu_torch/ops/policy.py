"""The port's knobs, read from the same environment variables as the
reference's (charon_tpu/ops/policy.py), with the same defaults and clamps:

  * CHARON_TPU_H2C_CACHE_CAP, default 4096: entries of plane_agg.H2CCache
    (a value that is not an integer reads as the default; <= 0 disables
    the cache). It is read when a TorchImpl is made.
  * CHARON_TPU_BREAKER_THRESHOLD, default 3, at least 1: consecutive
    device-class slot failures that open ops/guard.py's plane breaker. Read
    when a breaker is made (guard.BREAKER, guard.configure).
  * CHARON_TPU_BREAKER_COOLDOWN_S, default 30.0: seconds an open breaker
    keeps every slot on the native rung before one probe slot may try the
    device again (a negative value counts as 0 in the breaker).
  * CHARON_TPU_SLOT_DEADLINE_S, default 600.0: the watchdog deadline of a
    slot submitted through TorchImpl.threshold_aggregate_verify_submit; 0
    disables the watchdog. Read at each submit.

A value that does not parse reads as the default.

The coalescer (core/coalesce.py) reads two accessors, which have no
environment variable in the reference either:

  * flush_at_default(): the count that flushes a batching window, one
    verify chunk of 1,024 (the reference's TILE, plane_agg.VERIFY_CHUNK)
    times the devices the port drives, one. The reference's is TILE times
    its mesh's devices (8,192 on an 8-device mesh). An explicit flush_at
    given to the coalescer wins over it.
  * deadline_budget_override(): None, so the coalescer keeps its own
    admission budget (12 s by default), as the reference's does with no
    policy installed.

The reference's SlotPolicy seam (install / update / subscribe, epochs),
through which its autotuner manages `flush_at` and `deadline_budget_s`, is
not ported: no caller of the port installs a policy. Its other knobs are
left out with their variables: `pipeline_depth` and `finish_workers` (the
SigAggPipeline's, not ported: the port's submit front door runs the serial
slot on one thread), `field_plane` (the TPU's XLA or Pallas field plane;
the port has one set of kernels), `sigagg_devices` (the mesh clamp: the
multi-GPU slice) and `device_verify` (TorchImpl takes its verify rung
explicitly).
"""

from __future__ import annotations

import os

ENV_H2C_CACHE_CAP = "CHARON_TPU_H2C_CACHE_CAP"
ENV_BREAKER_THRESHOLD = "CHARON_TPU_BREAKER_THRESHOLD"
ENV_BREAKER_COOLDOWN = "CHARON_TPU_BREAKER_COOLDOWN_S"
ENV_SLOT_DEADLINE = "CHARON_TPU_SLOT_DEADLINE_S"
H2C_CACHE_CAP = 4096


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def h2c_cache_cap_default() -> int:
    return _env_int(ENV_H2C_CACHE_CAP, H2C_CACHE_CAP)


def breaker_threshold_default() -> int:
    return max(1, _env_int(ENV_BREAKER_THRESHOLD, 3))


def breaker_cooldown_default() -> float:
    return _env_float(ENV_BREAKER_COOLDOWN, 30.0)


def slot_deadline_default() -> float:
    return _env_float(ENV_SLOT_DEADLINE, 600.0)


def flush_at_default() -> int:
    """One verify chunk (plane_agg.VERIFY_CHUNK) on the port's one device."""
    from .plane_agg import VERIFY_CHUNK

    return VERIFY_CHUNK


def deadline_budget_override() -> float | None:
    return None
